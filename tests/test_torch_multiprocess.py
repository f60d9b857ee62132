"""The port's training loop across two Gloo processes on the CPU.

The twin of tests/test_multihost.py on its config (deterministic views, no
patches, no shuffling, eval_batch_size 2 so the sharded eval runs): two ranks, each on its shard of the train list at
half the global batch, against one process that sees the same scenes in
the ranks' interleaved order (the same global batches row for row):
per-epoch train loss and val score within rtol 1e-5; best score and final
weights equal on both ranks; only rank 0 wrote the run directory; and a
2-epoch run resumed to 4 ends bit-identical to an uninterrupted 4-epoch
two-rank run. Children run under 120 s each (``_torch_ranks.launch``).
"""

import copy
import os

import numpy as np
import pytest

import _torch_ranks as tr
from highresnet_tpu_torch.data.pipeline import shard_for_hosts
from highresnet_tpu_torch.data.synth import make_synthetic_dataset

LOOP_RTOL = 1e-5

CONFIG = {
    "network": {
        "encoder": {"in_channels": 2, "num_layers": 1, "kernel_size": 3, "channel_size": 8},
        "recursive": {"alpha_residual": True, "in_channels": 8, "kernel_size": 3},
        "decoder": {
            "deconv": {"in_channels": 8, "kernel_size": 3, "stride": 3, "out_channels": 8},
            "final": {"in_channels": 8, "kernel_size": 1, "out_channels": 1},
        },
    },
    "training": {
        "batch_size": 4, "min_L": 4, "n_views": -1, "crop": 1, "lr": 1e-3, "lr_step": 2,
        "lr_decay": 0.97, "beta": 50.0, "create_patches": False, "patch_size": 24,
        "register_size": 32, "val_proportion": 0.34, "lambda": 1e-6, "num_epochs": 2,
        "n_workers": 1, "seed": 0, "shuffle": False, "eval_batch_size": 2,
        "checkpoint_every": 0,
    },
    "paths": {"prefix": "", "checkpoint_dir": "", "tb_log_file_dir": ""},
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    # 8 scenes: 5 train / 3 val; each rank trains on 2 scenes a step
    root = tmp_path_factory.mktemp("mp")
    make_synthetic_dataset(str(root), n_scenes_per_channel=4, n_views=5, lr_size=24, seed=0,
                           splits=("train",))
    return str(root)


def _config(root, epochs):
    cfg = copy.deepcopy(CONFIG)
    cfg["training"]["num_epochs"] = epochs
    cfg["paths"].update(prefix=root, checkpoint_dir=os.path.join(root, "ckpt"))
    return cfg


def _job(root, run_dir, epochs, tag):
    return "loop", {"config": _config(root, epochs), "run_dir": run_dir}, tag


def test_two_processes_match_one_and_resume_bit_identically(root, tmp_path, monkeypatch):
    from highresnet_tpu_torch.train import loop

    # the one-process oracle first, alone: the train scenes in the two
    # ranks' global-batch order
    real_split = loop.train_val_split

    def interleaved(dirs, prop, seed=1):
        train, val = real_split(dirs, prop, seed=seed)
        h0, h1 = shard_for_hosts(train, 0, 2), shard_for_hosts(train, 1, 2)
        lb = CONFIG["training"]["batch_size"] // 2
        mixed = []
        for k in range(len(h0) // lb):
            mixed += h0[k * lb:(k + 1) * lb] + h1[k * lb:(k + 1) * lb]
        return mixed, val

    monkeypatch.setattr(loop, "train_val_split", interleaved)
    one = tr.run_loop(_config(root, 2), str(tmp_path / "one"))
    monkeypatch.undo()

    # the 2-epoch run and the uninterrupted 4-epoch run side by side, then
    # the resume of the first to 4
    pair, straight = tr.launch_jobs([_job(root, str(tmp_path / "two"), 2, "a"),
                                         _job(root, str(tmp_path / "straight"), 4, "c")],
                                        tmp_path)
    (resumed,) = tr.launch_jobs([_job(root, str(tmp_path / "two"), 4, "b")], tmp_path)

    assert one["world"] == 1 and [r["world"] for r in pair] == [2, 2]
    assert len(one["losses"]) == 2 and one["losses"][0] != 0.0
    for r in pair:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=LOOP_RTOL)
        np.testing.assert_allclose(r["vals"], one["vals"], rtol=LOOP_RTOL)
    # the ranks agree bit for bit, and rank 0 alone wrote
    for runs in (pair, resumed, straight):
        a, b = runs
        assert a["best_score"] == b["best_score"] and a["checksums"] == b["checksums"]
        assert a["losses"] == b["losses"] and a["vals"] == b["vals"]
        assert a["rank"] == 0 and a["writes"] and b["writes"] == []
        assert all(w.startswith(a["run_dir"]) for w in a["writes"])
    # 2 + 2 epochs in one run dir == 4 straight, bit for bit
    assert len(resumed[0]["losses"]) == 2 and len(straight[0]["losses"]) == 4
    assert resumed[0]["losses"] == straight[0]["losses"][2:]
    assert resumed[0]["vals"] == straight[0]["vals"]  # the resumed history holds all four
    assert resumed[0]["checksums"] == straight[0]["checksums"]
    assert resumed[0]["best_score"] == straight[0]["best_score"]
