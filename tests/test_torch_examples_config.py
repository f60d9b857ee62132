"""The flagship-config arc, ``flagship_config_report.drive``, on the CPU in
this process: ``materialize`` (the dataset and the four run configs), the
four arms through the port's ``cli.train``, the three ``cli.predict`` legs
(control and ft_varl with RuntimeWarning as an error), and the report in
FLAGSHIP_CONFIG_DRIVE.json's schema. ``run_flagship_config.sh`` is one call
of the same function (``--drive``), so the test and the script run one
sequence. Small: 8 scenes of 16 views at 16 px, a one-residual-layer HRNet
with 16 channels, 8 px patches, one epoch a stage, a 40-step warm-start.
"""

import json
import subprocess
import warnings
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
SCRIPT = REPO / "highresnet_tpu_torch" / "examples" / "run_flagship_config.sh"
NET = {
    "encoder": {"in_channels": 2, "num_layers": 1, "kernel_size": 3, "channel_size": 16},
    "recursive": {"alpha_residual": True, "in_channels": 16, "kernel_size": 3},
    "decoder": {
        "deconv": {"in_channels": 16, "kernel_size": 3, "stride": 3, "out_channels": 16},
        "final": {"in_channels": 16, "kernel_size": 1, "out_channels": 1},
    },
}
ARMS = (("control_run.json", "control"), ("flagship_run.json", "flagship"),
        ("ft_rp_run.json", "ft_rp"), ("ft_varl_run.json", "ft_varl"))


def test_run_flagship_config_drives_the_arc_and_writes_the_report(tmp_path, monkeypatch):
    from highresnet_tpu_torch.cli import predict, train
    from highresnet_tpu_torch.examples import flagship_config_report as report_module

    sh = SCRIPT.read_text()
    assert subprocess.run(["bash", "-n", str(SCRIPT)]).returncode == 0
    assert "python -m highresnet_tpu_torch.examples.flagship_config_report --drive" in sh

    calls = []
    real_train, real_predict = train.main, predict.main

    def spy_train(argv):
        calls.append(("train", argv))
        return real_train(argv)

    def spy_predict(argv):
        strict = warnings.filters[0][:3] == ("error", None, RuntimeWarning)
        table = real_predict(argv)
        calls.append(("predict", argv, strict, len(table)))
        return table

    monkeypatch.setattr(train, "main", spy_train)
    monkeypatch.setattr(predict, "main", spy_predict)
    root, out = tmp_path / "cfg", tmp_path / "drive.json"
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite runs files side by side
    try:
        report = report_module.drive(
            str(root), "cpu", str(out), configs_dir=str(REPO / "configs"),
            scenes_per_channel=4, lr_size=16,
            overrides={"network": NET, "training": {"num_epochs": 1, "batch_size": 4,
                                                    "patch_size": 8, "register_size": 16,
                                                    "n_workers": 1}},
            warmup_steps=40)
    finally:
        torch.set_num_threads(threads)

    assert [c[1][1] for c in calls if c[0] == "train"] == [str(root / cfg) for cfg, _ in ARMS]
    legs = [(Path(c[1][3]).name, "--tta" in c[1], c[2], c[3]) for c in calls if c[0] == "predict"]
    assert legs == [("control", False, True, 1), ("flagship", True, False, 1),
                    ("ft_varl", True, True, 1)]
    for _, arm in ARMS:
        assert (root / "ckpt" / arm / "best" / "HRNet.pth").is_file(), arm
    stages = {cfg: json.loads((root / cfg).read_text())["training"] for cfg, _ in ARMS}
    assert stages["ft_varl_run.json"]["init_params_from"] == str(root / "ckpt" / "ft_rp")
    assert stages["ft_rp_run.json"]["init_params_from"] == str(root / "ckpt" / "flagship")
    control = stages["control_run.json"]
    assert not control["register"] and "shiftnet_warmup_steps" not in control
    assert stages["flagship_run.json"]["shiftnet_warmup_steps"] == 40
    assert stages["ft_rp_run.json"]["shiftnet_warmup_steps"] == 0

    assert out.read_text() == json.dumps(report, indent=2)  # paired_t is NaN at n = 1
    ref = json.loads((REPO / "FLAGSHIP_CONFIG_DRIVE.json").read_text())
    assert list(report) == list(ref) and list(report["protocol"]) == list(ref["protocol"])
    assert list(report["comparisons"]) == list(ref["comparisons"])
    assert report["protocol"]["train_scenes"] == 8 and report["protocol"]["lr_size"] == 16
    assert [r["views"] for r in report["views_sweep"]["ft_varl"]] == [1, 2, 4, 8, 16]
    assert set(report["per_scene"]["flagship"]) == {"val_plain", "val_tta8",
                                                     "runtime_warning_count"}
