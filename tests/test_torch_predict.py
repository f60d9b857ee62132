"""The serving slice end to end: the JAX predict CLI on an Orbax checkpoint
against the port's predict CLI on the same weights exported as HRNet.pth,
per scene within the 0.01 dB parity contract; plus the port's import
boundary (no JAX) and the CLI's refusals."""

import ast
import importlib.util
import json
import re
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from highresnet_tpu.data.synth import make_synthetic_dataset

REPO = Path(__file__).resolve().parents[1]
PARITY_DB = 0.01
# the modules the measured-best recipe added (the warm-start, JAX's cubic
# resize, the dihedral transforms, the PCC alignment), the registration
# toolkit's, data parallelism's with the host tooling, the quality-experiment
# drivers, and the bench
NEW_MODULES = ("train.pretrain", "ops.resize", "ops.dihedral", "registration.search",
               "registration.warp", "registration.metrics", "registration.preprocess",
               "registration.session", "registration.app", "models.vgg",
               "cli.export_vgg_weights", "utils.display", "utils.heatmap_canvas",
               "parallel.distributed", "parallel.mesh", "cli.save_clearance",
               "cli.pack_dataset", "utils.profiling", "utils.flops", "exp.harness", "dryrun",
               "bench", "labs.common",  # with the perf labs below
               "models.rams", "models.network",  # RAMS, and the network a config names
               "models.trmisr", "ops.attention",  # TR-MISR and its attention core
               *(f"labs.{name}" for name in (
                   "fusion_lab", "fusion_lab2", "fusion_lab3", "bench_breakdown",
                   "trace_train_step")),
               *(f"examples.{name}" for name in (
                   "quality_report", "test_model", "display_dataset", "quality_experiment",
                   "views_ablation", "register_ablation", "tta_experiment", "flagship_recipe",
                   "ensemble_experiment", "recipe_report", "flagship_config_report",
                   "precision_ablation", "pipeline_bench")))

NET = {
    "encoder": {"in_channels": 2, "num_layers": 1, "kernel_size": 3, "channel_size": 16},
    "recursive": {"alpha_residual": True, "in_channels": 16, "kernel_size": 3},
    "decoder": {
        "deconv": {"in_channels": 16, "kernel_size": 3, "stride": 3, "out_channels": 16},
        "final": {"in_channels": 16, "kernel_size": 1, "out_channels": 1},
    },
}


def _load_export_script():
    spec = importlib.util.spec_from_file_location(
        "export_torch_weights", REPO / "scripts" / "export_torch_weights.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _export(served):
    """scripts/export_torch_weights.py: best/ (Orbax) -> best/HRNet.pth."""
    cfg_path, run_dir = served
    return _load_export_script().main(["--config", cfg_path, "--run-dir", run_dir])


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A synthetic dataset, a config, and a JAX run dir with best/ weights."""
    from highresnet_tpu.models.hrnet import HRNet as JaxHRNet
    from highresnet_tpu.train.checkpoint import CheckpointManager

    tmp = tmp_path_factory.mktemp("serve")
    root = make_synthetic_dataset(str(tmp / "data"), n_scenes_per_channel=1, n_views=4,
                                  lr_size=16, seed=5)
    cfg_path = str(tmp / "config.json")
    with open(cfg_path, "w") as f:
        json.dump({"paths": {"prefix": root}, "network": NET,
                   "training": {"min_L": 4, "single_view_policy": "model"}}, f)
    variables = JaxHRNet(config=NET).init(
        jax.random.PRNGKey(4), jnp.zeros((1, 4, 16, 16)), jnp.ones((1, 4))
    )
    run_dir = str(tmp / "run")
    ckpt = CheckpointManager(run_dir)
    ckpt.save_best(variables["params"], {}, score=-1.0)
    ckpt.wait()
    return cfg_path, run_dir


def _captured_scores(monkeypatch, module):
    """Record the per-scene scores a CLI hands to its benchmark table."""
    seen = {}
    real = module.benchmark

    def spy(baseline, scores, part, clearances):
        seen.update(scores)
        return real(baseline, scores, part, clearances)

    monkeypatch.setattr(module, "benchmark", spy)
    return seen


def test_predict_cli_matches_jax_per_scene(served, monkeypatch, tmp_path):
    from highresnet_tpu.cli.predict import main as jax_predict
    from highresnet_tpu.eval import evaluator as jax_evaluator
    from highresnet_tpu_torch.cli.predict import main as port_predict
    from highresnet_tpu_torch.eval import evaluator as port_evaluator

    cfg_path, run_dir = served
    argv = ["--config", cfg_path, "--checkpoint", run_dir, "--splits", "train", "val"]

    jax_scores = _captured_scores(monkeypatch, jax_evaluator)
    jax_predict(argv)

    assert _export(served) == str(Path(run_dir) / "best" / "HRNet.pth")

    port_scores = _captured_scores(monkeypatch, port_evaluator)
    table = port_predict([*argv, "--device", "cpu", "--submission", str(tmp_path / "sub")])

    assert sorted(port_scores) == sorted(jax_scores) and len(jax_scores) == 2
    for name, want in jax_scores.items():
        assert np.isfinite(want)
        assert abs(port_scores[name] - want) <= PARITY_DB, (name, port_scores[name], want)
        assert float(table.loc[name, "model"]) == pytest.approx(port_scores[name])
    assert (tmp_path / "sub" / "submission.zip").is_file()


def test_port_leaves_jax_unimported():
    """Every module of the port, labs included, imports neither JAX nor the
    JAX package (not even its JAX-free host code)."""
    code = (
        f"NEW = {NEW_MODULES!r}\n"
        "import importlib, pkgutil, sys\n"
        "import highresnet_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(highresnet_tpu_torch.__path__,\n"
        "                                              'highresnet_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "from highresnet_tpu_torch import HRNet, Model, load_config, load_data\n"
        "for name in NEW:\n"
        "    assert 'highresnet_tpu_torch.' + name in names, name\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'flax', 'optax', 'orbax', 'highresnet_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    modules = sorted((REPO / "highresnet_tpu_torch").rglob("*.py"))
    assert int(proc.stdout.strip()) == len(modules) - 1  # every module but the package's own __init__


def test_port_sources_have_no_jax_and_no_torch_compile():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|orbax)\b|torch\.compile", re.M)
    files = sorted((REPO / "highresnet_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for module in ("train/loop.py", "train/step.py", "ops/lanczos_fused.py", "cli/train.py",
                   *(m.replace(".", "/") + ".py" for m in NEW_MODULES)):
        assert REPO / "highresnet_tpu_torch" / module in files, module
    offenders = [str(p) for p in files if pattern.search(p.read_text())]
    assert not offenders
    # neither the port nor the GPU-side scripts import the JAX package, not
    # even its JAX-free host code: the port keeps its own copies
    jax_package = re.compile(r"^\s*(import|from)\s+highresnet_tpu\b(?!_torch)", re.M)
    assert not [str(p) for p in files if jax_package.search(p.read_text())]
    assert REPO / "highresnet_tpu_torch" / "labs" / "fusion_lab4.py" in files


def test_port_sources_keep_the_network_and_serving_seams():
    """``network.arch`` is read only by ``config.py`` and ``models/network.py``;
    each weights file name is defined once; ``eval/`` imports nothing from
    ``train/``; and no module outside the evaluator uses its private names."""
    port = REPO / "highresnet_tpu_torch"
    sources = sorted(port.rglob("*.py"))
    files = sources + sorted((REPO / "tests").glob("test_torch_*.py")) + [
        REPO / "chip_smoke.py", REPO / "scripts" / "export_torch_weights.py"]
    arch = re.compile(r"\bnetwork_arch\b|[\"']arch[\"']")
    assert {p.relative_to(port).as_posix() for p in sources if arch.search(p.read_text())} == {
        "config.py", "models/network.py"}
    evaluator = "highresnet_tpu_torch.eval.evaluator"
    defined, private = [], []
    for path in files:
        tree = ast.parse(path.read_text())
        bound = set()  # the names the port's evaluator module is bound to here
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant):
                if node.value.value in ("HRNet.pth", "ShiftNet.pth"):
                    defined.append((node.value.value, path.name))
            modules = ([node.module] if isinstance(node, ast.ImportFrom)
                       else [a.name for a in node.names] if isinstance(node, ast.Import) else [])
            if path.is_relative_to(port / "eval"):
                assert not any(m and m.startswith("highresnet_tpu_torch.train")
                               for m in modules), path
            if isinstance(node, ast.ImportFrom) and node.module:
                if node.module == evaluator:
                    private += [(path.name, a.name) for a in node.names if a.name[0] == "_"]
                if node.module == "highresnet_tpu_torch.eval":
                    bound |= {a.asname or a.name for a in node.names if a.name == "evaluator"}
            if isinstance(node, ast.Import):
                bound |= {a.asname for a in node.names if a.name == evaluator and a.asname}
        if path != port / "eval" / "evaluator.py":
            private += [(path.name, node.attr) for node in ast.walk(tree)
                        if isinstance(node, ast.Attribute) and node.attr[0] == "_"
                        and isinstance(node.value, ast.Name) and node.value.id in bound]
    assert sorted(defined) == [("HRNet.pth", "convert.py"), ("ShiftNet.pth", "convert.py")]
    assert not private


def test_cpu_model_changes_no_process_setting(served):
    """Only setup_device on a CUDA device touches the global numerics flags."""
    from highresnet_tpu.config import load_config
    from highresnet_tpu_torch.eval.evaluator import Model
    from highresnet_tpu_torch.runtime import setup_device

    before = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.benchmark)
    assert setup_device("cpu") == torch.device("cpu")
    Model(load_config(served[0]), device="cpu").load_checkpoint(_export(served))
    assert (torch.are_deterministic_algorithms_enabled(),
            torch.backends.cudnn.benchmark) == before


@pytest.mark.parametrize("extra, message", [
    (["--checkpoint", "a", "b", "--registered"],
     "--registered (ShiftNet-registered scoring) is not supported with ensemble inference"),
    (["--checkpoint", "a", "b", "--tta", "4"], "--tta is single-checkpoint only"),
    (["--tta", "8", "--registered"], "--tta cannot be combined with --registered scoring"),
])
def test_predict_cli_refuses_what_is_not_ported(served, extra, message, capsys):
    """The combinations the JAX CLI refuses, with its words, before any
    checkpoint is read."""
    from highresnet_tpu_torch.cli.predict import main as port_predict

    cfg_path, run_dir = served
    argv = ["--config", cfg_path, "--checkpoint", run_dir, "--device", "cpu", *extra]
    with pytest.raises(SystemExit):
        port_predict(argv)
    assert message in capsys.readouterr().err


def test_cuda_request_without_a_card_raises(served):
    from highresnet_tpu.config import load_config
    from highresnet_tpu_torch.eval.evaluator import Model

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(load_config(served[0]), device="cuda")


def test_load_model_defaults_to_the_card_and_raises_without_one(served, monkeypatch, tmp_path):
    """load_model and evaluate_model run on the card unless the caller asks
    for the CPU; with no card, load_model raises before reading anything."""
    import inspect

    from highresnet_tpu.config import load_config
    from highresnet_tpu_torch.eval.evaluator import load_model
    from highresnet_tpu_torch.train.evaluation import evaluate_model

    cfg = load_config(served[0])
    assert inspect.signature(load_model).parameters["device"].default == "cuda"
    assert inspect.signature(evaluate_model).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_model(cfg, str(tmp_path / "no_such_checkpoint"))
    model = load_model(cfg, _export(served), device="cpu")
    assert next(model.parameters()).device.type == "cpu" and not model.training


def test_submission_honours_single_view_policy(served, tmp_path):
    """The JAX writer drops single_view_policy; the port's passes it on."""
    from highresnet_tpu.config import load_config
    from highresnet_tpu_torch.data import ImageSet
    from highresnet_tpu_torch.eval.evaluator import Model

    cfg = load_config(served[0])
    rng = np.random.default_rng(0)
    one_view = ImageSet(name="imgset9999", lr=rng.random((1, 16, 16), dtype=np.float32),
                        hr=None, hr_map=None)
    weights = _export(served)
    for policy, warns in (("warn", True), ("model", False)):
        cfg["training"]["single_view_policy"] = policy
        model = Model(cfg, device="cpu")
        model.load_checkpoint(weights)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            archive = model.generate_submission_file([one_view], out=str(tmp_path / policy))
        single = [w for w in caught if "single-view" in str(w.message)]
        assert bool(single) == warns, policy
        assert Path(archive).is_file()
