"""The port's 2-D layout through its training loop, and its dry run, on the CPU.

- ``train_and_get_best_model`` with ``training.mesh = {"data": 2, "view":
  2}`` on four Gloo ranks (``tests/_torch_ranks.py``) against one process
  that sees the same global batches (the two replicas' shards interleaved):
  per-step train losses within rtol 1e-4 / atol 1e-5, the bar of the JAX
  loop test (tests/test_parallel.py::test_loop_level_2d_mesh_matches_1d),
  and the val scores within rtol 1e-4; the four ranks bit-identical; rank 0
  alone writes the run directory.
- ``python -m highresnet_tpu_torch.dryrun 4 --device cpu``: every leg of the
  port of ``__graft_entry__.dryrun_multichip`` passes on the 2-D layout, and
  ``entry`` gives a finite SR of the JAX entry's shape.
"""

import copy
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import _torch_ranks as tr
from highresnet_tpu_torch.data.pipeline import shard_for_hosts
from highresnet_tpu_torch.data.synth import make_synthetic_dataset

REPO = Path(__file__).resolve().parents[1]
STEP_RTOL, STEP_ATOL = 1e-4, 1e-5

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
MESH = {"data": 2, "view": 2}


def test_2d_loop_matches_one_process(tmp_path, monkeypatch):
    from highresnet_tpu_torch.train import loop

    # 16 scenes: 10 train / 6 val; each replica trains on 2 scenes a step, 2 steps an epoch
    root = str(tmp_path / "set")
    make_synthetic_dataset(root, n_scenes_per_channel=8, n_views=5, lr_size=24, seed=0,
                           splits=("train",))
    cfg = copy.deepcopy(CONFIG)
    cfg["paths"].update(prefix=root, checkpoint_dir=str(tmp_path / "ckpt"))
    meshed = copy.deepcopy(cfg)
    meshed["training"]["mesh"] = MESH
    (ranks,) = tr.launch_jobs([("loop", {"config": meshed, "run_dir": str(tmp_path / "four")},
                                "2d", 4)], tmp_path)

    # the one-process oracle: the train scenes in the two replicas'
    # global-batch order
    real_split = loop.train_val_split
    local = CONFIG["training"]["batch_size"] // MESH["data"]

    def interleaved(dirs, prop, seed=1):
        train, val = real_split(dirs, prop, seed=seed)
        shards = [shard_for_hosts(train, d, MESH["data"]) for d in range(MESH["data"])]
        mixed = []
        for k in range(len(shards[0]) // local):
            for shard in shards:
                mixed += shard[k * local:(k + 1) * local]
        return mixed, val

    monkeypatch.setattr(loop, "train_val_split", interleaved)
    one = tr.run_loop(cfg, str(tmp_path / "one"))

    assert [r["world"] for r in ranks] == [4] * 4 and one["world"] == 1
    assert len(one["step_losses"]) == 4 and all(np.isfinite(one["step_losses"]))
    for r in ranks:
        np.testing.assert_allclose(r["step_losses"], one["step_losses"], rtol=STEP_RTOL,
                                   atol=STEP_ATOL)
        np.testing.assert_allclose(r["vals"], one["vals"], rtol=STEP_RTOL)
    a, *rest = ranks
    for b in rest:
        assert (b["step_losses"], b["vals"], b["checksums"], b["best_score"]) == \
            (a["step_losses"], a["vals"], a["checksums"], a["best_score"])
        assert b["writes"] == []
    assert a["rank"] == 0 and a["writes"]
    assert all(w.startswith(a["run_dir"]) for w in a["writes"])


def test_dryrun_runs_every_leg_on_four_processes():
    env = {k: v for k, v in os.environ.items() if not k.startswith("HRN_")}
    proc = subprocess.run([sys.executable, "-m", "highresnet_tpu_torch.dryrun", "4",
                           "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("dryrun_multichip(4)")]
    legs = ["[2D layout (data=2, view=2)]", "[sharded eval", "[ckpt round-trip",
            "[variable-L loader"]
    assert len(lines) == len(legs), proc.stdout
    for line, leg in zip(lines, legs):
        assert leg in line and line.endswith("OK"), line


def test_entry_forward_at_full_width():
    from highresnet_tpu_torch.dryrun import entry

    fn, args = entry("cpu")
    out = fn(*args)
    assert out.shape == (2, 192, 192) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
