"""The port's host tooling against the JAX package, on the CPU.

- ``cli.save_clearance`` and ``cli.pack_dataset`` write files byte-identical
  to the JAX CLIs' on two copies of one ``data/synth.py`` set;
- every count of ``utils/flops.py`` equals JAX's at configs/config.json's
  and configs/flagship.json's shapes, and ``utilization`` takes the H100's
  peaks;
- ``exp/harness.py``: ``bicubic_x3`` within 1e-6 of JAX's; ``paired_t``,
  ``paired_stats``, ``overflow_metrics``, ``held_out_scenes``,
  ``emit_report`` equal to JAX's; ``scene_scorer`` within 1e-4 dB;
  ``ensure_dataset`` builds, reuses and packs;
- ``utils/profiling.py``: ``timed`` and ``trace`` run on the CPU, and
  ``training.debug_nans`` turns on anomaly detection in the train loop.
"""

import copy
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from highresnet_tpu.config import load_config as jax_load_config
from highresnet_tpu.data.synth import make_synthetic_dataset

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def two_sets(tmp_path_factory):
    """Two copies of one synthetic set (train and test splits)."""
    roots = []
    for name in ("jax", "port"):
        root = str(tmp_path_factory.mktemp(name))
        make_synthetic_dataset(root, n_scenes_per_channel=2, n_views=5, lr_size=16, seed=4,
                               splits=("train", "test"))
        roots.append(root)
    return roots


def _files(root, name):
    return sorted(Path(root).rglob(name))


def test_data_prep_clis_write_the_jax_bytes(two_sets, capsys):
    from highresnet_tpu.cli import pack_dataset as jax_pack
    from highresnet_tpu.cli import save_clearance as jax_clear
    from highresnet_tpu_torch.cli import pack_dataset, save_clearance

    jax_root, port_root = two_sets
    for name in ("clearance.npy", "packed.npz"):
        for p in _files(jax_root, name) + _files(port_root, name):
            p.unlink()
    jax_clear.main(["--prefix", jax_root])
    save_clearance.main(["--prefix", port_root])
    jax_pack.main(["--prefix", jax_root])
    pack_dataset.main(["--prefix", port_root])
    out = capsys.readouterr().out
    assert "train: wrote clearance.npy for 4 scenes" in out and "test: packed 4 scenes" in out
    for name in ("clearance.npy", "packed.npz"):
        want, got = _files(jax_root, name), _files(port_root, name)
        assert len(want) == len(got) == 8
        for w, g in zip(want, got):
            assert w.relative_to(jax_root) == g.relative_to(port_root)
            if name == "clearance.npy":
                assert w.read_bytes() == g.read_bytes(), g
            else:  # a zip's member dates are the writing second: compare the members' bytes
                with np.load(w) as a, np.load(g) as b:
                    assert a.files == b.files
                    for k in a.files:
                        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    with pytest.raises(SystemExit):
        save_clearance.main(["--prefix", os.path.join(port_root, "missing")])


@pytest.mark.parametrize("config", ["config.json", "flagship.json"])
def test_flop_counts_equal_jax(config):
    from highresnet_tpu.utils import flops as jax_flops
    from highresnet_tpu_torch.utils import flops

    cfg = jax_load_config(str(REPO / "configs" / config))
    net, t = cfg["network"], cfg["training"]
    b, l, p, r = t["batch_size"], t["min_L"], t["patch_size"], t.get("register_size", 128)
    for name, args in [
        ("conv_flops", (64, 48, 2, 64)),
        ("hrnet_forward_flops", (net, b, l, 128)),
        ("shiftnet_forward_flops", (b, r)),
        ("lanczos_warp_flops", (b, 3 * p)),
        ("train_step_flops", (net, b, l, p, r)),
        ("eval_step_flops", (net, t.get("eval_batch_size", 1), l, 128)),
    ]:
        assert getattr(flops, name)(*args) == getattr(jax_flops, name)(*args), name


def test_utilization_on_the_h100_basis():
    from highresnet_tpu_torch.utils.flops import utilization

    assert utilization(33.5e12, 1.0) == {"achieved_tflops_per_s": 33.5, "utilization": 0.5,
                                         "peak_basis_tflops_per_s": 67.0}
    assert utilization(989e12, 2.0, "bfloat16")["utilization"] == 0.5
    assert utilization(1e15, 1.0)["timing_suspect"] is True
    assert utilization(1.0, 0.0)["utilization"] is None


def test_bicubic_and_scorer_match_jax(two_sets):
    from highresnet_tpu.data import discover_scenes, read_imageset
    from highresnet_tpu.exp import harness as jax_harness
    from highresnet_tpu_torch.exp import harness

    s = read_imageset(discover_scenes(os.path.join(two_sets[0], "train"))[0])
    img = s.lr[0]  # the baseline's input: an LR view
    got = harness.bicubic_x3(img, device="cpu")
    assert got.shape == (48, 48) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_harness.bicubic_x3(img)), atol=1e-6)

    sr = (np.asarray(jax_harness.bicubic_x3(img)) * 1.1).astype(np.float32)
    np.testing.assert_allclose(harness.scene_scorer(s, device="cpu")(sr),
                               jax_harness.scene_scorer(s)(sr), atol=1e-4)


def test_statistics_and_report_equal_jax(two_sets, tmp_path, capsys):
    from highresnet_tpu.exp import harness as jax_harness
    from highresnet_tpu_torch.exp import harness

    rng = np.random.default_rng(1)
    a, b = rng.normal(30, 1, 9).tolist(), rng.normal(29.5, 1, 9).tolist()
    deltas = [x - y for x, y in zip(a, b)]
    for d in (deltas, deltas[:1], [0.5, 0.5, 0.5], []):
        assert harness.paired_t(d) == jax_harness.paired_t(d)
    assert harness.paired_stats(a, b) == jax_harness.paired_stats(a, b)
    sr = rng.normal(0.5, 0.4, (24, 24)).astype(np.float32)
    sr[10, 10] = 1.7  # the largest overflow sits inside the scored region
    for img in (sr, np.clip(sr, 0, 1), sr[::-1].copy()):
        assert harness.overflow_metrics(img) == jax_harness.overflow_metrics(img)
        assert harness.overflow_metrics(torch.from_numpy(img)) == jax_harness.overflow_metrics(img)
    for n in (None, 1):
        assert (harness.held_out_scenes(two_sets[0], 0.34, n)
                == jax_harness.held_out_scenes(two_sets[0], 0.34, n))
    report = {"arms": {"a": 1.5}, "per_scene": [1, 2, 3], "n": 3}
    for module, name in ((harness, "port.json"), (jax_harness, "jax.json")):
        module.emit_report(str(tmp_path / name), report, slim_drop=("per_scene",))
    printed = capsys.readouterr().out.split("\n}\n")
    assert printed[0] == printed[1] and "per_scene" not in printed[0]
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


def test_ensure_dataset_builds_reuses_and_packs(tmp_path, capsys):
    from highresnet_tpu_torch.data.pack import PACK_NAME
    from highresnet_tpu_torch.exp.harness import ensure_dataset

    root = str(tmp_path / "set")
    kw = dict(scenes_per_channel=2, views=4, lr_size=16, seed=0, detail=0.5)
    ensure_dataset(root, **kw)
    packs = _files(root, PACK_NAME)
    assert len(packs) == 4 and "dataset: 4 scenes" in capsys.readouterr().out
    packs[0].unlink()
    ensure_dataset(root, **kw)  # reused; the missing pack topped up
    assert "packed 1 unpacked scenes" in capsys.readouterr().out
    assert len(_files(root, PACK_NAME)) == 4


def test_timed_and_trace_run_on_the_cpu(tmp_path):
    from highresnet_tpu_torch.utils.profiling import sync, timed, trace

    x = torch.randn(64, 64)
    seconds, out = timed(torch.matmul, x, x, iters=3, warmup=1)
    assert seconds > 0 and torch.equal(out, x @ x)
    sync({"a": [out, (out,)]})
    with trace(str(tmp_path / "t")) as path:
        torch.matmul(x, x)
    events = json.loads(Path(path).read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)


def test_debug_nans_turns_on_anomaly_detection(tmp_path, monkeypatch):
    from highresnet_tpu_torch.train import loop

    seen = []
    real = loop.run_train_epoch

    def epoch(*args, **kwargs):
        seen.append(torch.is_anomaly_enabled())
        return real(*args, **kwargs)

    root = str(tmp_path / "set")
    make_synthetic_dataset(root, n_scenes_per_channel=2, n_views=4, lr_size=16, seed=0,
                           splits=("train",))
    cfg = jax_load_config(str(REPO / "configs" / "config.json"))
    cfg = copy.deepcopy(cfg)
    cfg["network"]["encoder"]["channel_size"] = 4
    cfg["network"]["recursive"]["in_channels"] = 4
    cfg["network"]["decoder"]["deconv"].update(in_channels=4, out_channels=4)
    cfg["network"]["decoder"]["final"]["in_channels"] = 4
    cfg["training"].update(num_epochs=1, batch_size=2, min_L=2, n_views=2, patch_size=16,
                           register_size=32, val_proportion=0.34, n_workers=1, debug_nans=True)
    cfg["paths"].update(prefix=root, checkpoint_dir=str(tmp_path / "runs"), tb_log_file_dir="")
    monkeypatch.setattr(loop, "run_train_epoch", epoch)
    try:
        loop.train_and_get_best_model(cfg, run_dir=str(tmp_path / "run"), device="cpu")
    finally:
        torch.autograd.set_detect_anomaly(False)
    assert seen == [True]
