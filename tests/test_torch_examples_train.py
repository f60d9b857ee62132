"""The training drivers of ``highresnet_tpu_torch/examples/`` end to end on the
CPU at a small size: a one-residual-layer HRNet with 16 channels (the JAX
drivers' default network, narrowed through ``load_config``), 4 views of
16 px, 8 px patches, one or two epochs.

- ``quality_experiment`` twice from scratch gives identical per-scene
  numbers and the report schema of the current JAX driver's reports
  (``RECIPE_FT_CTL.json``; ``QUALITY_REPORT.json`` predates the selection
  block); ``views_ablation`` then takes its newest run dir by default;
- ``flagship_recipe`` runs both arms (the 400-step warm-start included) on a
  fresh test set from seed + 7777 and writes FLAGSHIP_RECIPE.json's schema,
  at its defaults and under ``--train-seed``;
- ``register_ablation`` appends a protocol per run to one report;
- ``ensemble_experiment`` trains two members and scores them with x4 TTA on
  a fresh test set.
The scoring legs themselves are held against JAX in test_torch_examples.py.
"""

import json
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
NET = {
    "encoder": {"in_channels": 2, "num_layers": 1, "kernel_size": 3, "channel_size": 16},
    "recursive": {"alpha_residual": True, "in_channels": 16, "kernel_size": 3},
    "decoder": {
        "deconv": {"in_channels": 16, "kernel_size": 3, "stride": 3, "out_channels": 16},
        "final": {"in_channels": 16, "kernel_size": 1, "out_channels": 1},
    },
}
SMALL = ["--views", "4", "--lr-size", "16", "--patch", "8", "--batch", "4", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs files side by side."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def narrow_network(monkeypatch):
    """Every config a driver loads gets the small network."""
    import highresnet_tpu_torch.config as config_module

    real = config_module.load_config
    monkeypatch.setattr(config_module, "load_config",
                        lambda *a, **k: {**real(*a, **k), "network": NET})


def _keys(name: str) -> dict:
    return json.loads((REPO / name).read_text())


def test_quality_experiment_repeats_and_keeps_the_schema(tmp_path):
    from highresnet_tpu_torch.examples import quality_experiment, views_ablation

    reports = []
    for i in range(2):
        root = tmp_path / f"data{i}"
        reports.append(quality_experiment.main([
            "--root", str(root), "--scenes-per-channel", "4", "--epochs", "2", *SMALL,
            "--out", str(tmp_path / f"q{i}.json")]))
    a, b = reports
    assert a["per_scene"] == b["per_scene"] and len(a["per_scene"]) == 2
    assert a["selection"] == b["selection"] and len(a["selection"]["val_history"]) == 2
    ref = _keys("RECIPE_FT_CTL.json")
    assert list(a) == list(ref) and list(a["protocol"]) == list(ref["protocol"])
    assert list(a["selection"]) == list(ref["selection"])
    old = _keys("QUALITY_REPORT.json")
    assert set(old) <= set(a) and set(old["protocol"]) <= set(a["protocol"])
    assert a["protocol"]["device"] == "cpu" and a["protocol"]["scenes"] == 8
    assert json.loads((tmp_path / "q0.json").read_text()) == a

    sweep = views_ablation.main(["--root", str(tmp_path / "data0"), "--views", "1", "2", "4",
                                 "--val-proportion", "0.25", "--device", "cpu",
                                 "--out", str(tmp_path / "v.json")])
    assert Path(sweep["checkpoint"]).parent == tmp_path / "data0" / "ckpt"
    assert [r["views"] for r in sweep["by_views"]] == [1, 2, 4] and sweep["n_scenes"] == 2
    # the sweep's 4-view row scores the same weights and draws as the report
    want = sum(r["mfsr"] for r in a["per_scene"]) / 2
    assert abs(sweep["by_views"][-1]["mean_shift_cpsnr"] - want) <= 1e-4


@pytest.mark.parametrize("given", [{}, {"train_seed": 5}], ids=["default", "train_seed"])
def test_flagship_recipe_runs_both_arms(tmp_path, monkeypatch, given):
    """At the defaults the report keeps FLAGSHIP_RECIPE.json's keys exactly;
    ``--train-seed`` sets training.seed alone (the datasets stay those of
    ``--seed``), is a ``protocol`` key after ``seed`` and names the arms'
    run dirs."""
    from highresnet_tpu_torch.examples import flagship_recipe
    from highresnet_tpu_torch.train import loop

    seen = []
    real = loop.train_and_get_best_model
    monkeypatch.setattr(loop, "train_and_get_best_model", lambda config, **kw: (
        seen.append(config["training"]["seed"]), real(config, **kw))[1])
    extra = [f"--{k.replace('_', '-')}={v}" for k, v in given.items()]
    report = flagship_recipe.main([
        "--root", str(tmp_path / "train"), "--test-root", str(tmp_path / "test"),
        "--scenes-per-channel", "4", "--test-scenes-per-channel", "2", "--epochs", "1",
        "--views", "4", "--lr-size", "16", "--patch", "8", "--batch", "4", "--device", "cpu",
        "--out", str(tmp_path / "f.json"), *extra])
    ref = _keys("FLAGSHIP_RECIPE.json")
    want_protocol = list(ref["protocol"])
    at = want_protocol.index("seed") + 1
    want_protocol[at:at] = list(given)
    assert all(report["protocol"][k] == v for k, v in given.items())
    assert seen == [given.get("train_seed", 123)] * 2
    suffix = "".join(f"_{k}{v}" for k, v in given.items())
    assert {p.name for p in (tmp_path / "train").glob("ckpt_*")} == \
        {f"ckpt_plain{suffix}", f"ckpt_full{suffix}"}
    assert list(report) == list(ref) and list(report["protocol"]) == want_protocol
    assert list(report["comparisons"]) == list(ref["comparisons"])
    assert set(report["arms"]) == {"plain", "full"}
    for arm in report["arms"].values():
        assert set(ref["arms"]["plain"]) <= set(arm) and len(arm["val_history"]) == 1
        assert all(len(v) == 4 for v in arm["per_scene_shift_cpsnr"].values())
    assert report["protocol"]["fresh_test_scenes"] == 4
    assert all(c["n"] == 4 for c in report["comparisons"].values())
    # the fresh test set is the JAX driver's: generator seed + 7777
    from highresnet_tpu_torch.data import make_synthetic_dataset

    twin = make_synthetic_dataset(str(tmp_path / "twin"), n_scenes_per_channel=2, n_views=4,
                                  lr_size=16, seed=7777, splits=("train",), detail=0.5,
                                  hr_shift_sigma=1.25, write_norm_csv=False)
    hr = sorted((tmp_path / "test").rglob("HR.png"))
    assert len(hr) == 4 and [p.read_bytes() for p in hr] == \
        [p.read_bytes() for p in sorted(Path(twin).rglob("HR.png"))]


def test_register_ablation_appends_a_protocol_per_run(tmp_path):
    from highresnet_tpu_torch.examples import register_ablation

    argv = ["--root", str(tmp_path / "d"), "--scenes-per-channel", "4", "--epochs", "1",
            "--arms", "unregistered,registered_plain", "--max-scenes", "2",
            "--val-proportion", "0.25", *SMALL,
            "--out", str(tmp_path / "r.json")]
    register_ablation.main(argv)
    report = register_ablation.main(argv)  # resumes the finished arms, appends
    assert len(report["protocols"]) == 2
    first, second = report["protocols"]
    strip = lambda arms: {k: {f: x for f, x in v.items() if f != "train_seconds"}
                          for k, v in arms.items()}
    assert strip(first["arms"]) == strip(second["arms"])
    for arm in first["arms"].values():
        assert arm["mean_fractional_cpsnr"] >= arm["mean_shift_cpsnr"] - 0.5
        assert len(arm["per_scene_shift_cpsnr"]) == 2
    assert first["training_protocol"]["device"] == "cpu"


def test_ensemble_experiment_with_tta_on_a_fresh_set(tmp_path):
    from highresnet_tpu_torch.examples import ensemble_experiment

    report = ensemble_experiment.main([
        "--root", str(tmp_path / "d"), "--scenes-per-channel", "4", "--epochs", "1",
        "--seeds", "0,1", "--tta", "4", "--fresh-test-seed", "77", "--fresh-test-scenes", "2",
        *SMALL, "--out", str(tmp_path / "e.json")])
    ref = _keys("ENSEMBLE_TTA_STACK.json")
    assert list(report) == list(ref) and list(report["protocol"]) == list(ref["protocol"])
    assert len(report["per_scene"]) == 4 and report["tta_transforms"] == 4
    assert {"seed0", "seed1", "tta0", "tta1", "full_stack", "ens01", "rens01"} == \
        set(report["per_scene"][0]) - {"scene"}
    assert report["stacking"]["n_fit_scenes"] == 2 and "stacked" in \
        report["stacking"]["test_half_mean_shift_cpsnr"]
