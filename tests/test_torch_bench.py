"""The port's bench (``highresnet_tpu_torch/bench.py``) against the JAX
bench, on the CPU, and the research-queue scripts' legs.

- ``python -m highresnet_tpu_torch.bench --smoke --device cpu`` prints the
  JAX bench's four-key line last and writes its details to ``--out``, never
  to the root ``BENCH_DETAILS.json``;
- the row table equals the JAX bench's rows, and each row's FLOP count
  equals the JAX package's;
- at the smoke shape the bench's forward on weights carried over from JAX
  equals ``hrnet.apply``, and at a tiny width the eval row's scores equal
  JAX's eval step, so the bench times the functions the JAX bench times;
- the train and eval rows run at a tiny width (f32 parameters, gradients
  and Adam moments under bf16; the startup entry), a failing row is
  recorded and the next one runs, and a CUDA request without a card raises;
- ``examples/run_ft_rponly.sh`` and ``run_round5_queue.sh`` pass ``bash
  -n``, and every leg's flags, as the script passes them, parse in the
  port's driver; the fixL cross-check records the first base and stops on
  a base that differs from it.
"""

import copy
import importlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from highresnet_tpu.config import DEFAULT_CONFIG as JAX_DEFAULT_CONFIG
from highresnet_tpu.models.hrnet import HRNet as JaxHRNet
from highresnet_tpu.utils import flops as jax_flops
from highresnet_tpu_torch import bench
from highresnet_tpu_torch.config import DEFAULT_CONFIG
from highresnet_tpu_torch.models import HRNet, hrnet_state_dict_from_flax

REPO = Path(__file__).resolve().parent.parent
THREADS = 2  # the suite runs files in parallel workers (ROADMAP H12)
KEYS = {"metric", "value", "unit", "vs_baseline"}  # tests/test_misc.py::test_bench_smoke

# The JAX bench's rows (bench.py), as (name, batch, views, size or patch, dtype):
# :276 the smoke config, :292 the headline, :312 bf16 headline, :316-317 the
# train steps (bench_train_step's defaults, :145: batch 32, 32 views, patch
# 64), :319 the eval step (bench_eval_step's defaults, :222: batch 8, 16
# views, 128 px), :321 32-view f32, :322 batch-32 bf16, :328 batch-1 latency
JAX_ROWS = [
    ("smoke", 1, 2, 16, "float32"),
    ("headline", 8, 16, 128, "float32"),
    ("bf16 headline", 8, 16, 128, "bfloat16"),
    ("train step f32", 32, 32, 64, "float32"),
    ("train step bf16", 32, 32, 64, "bfloat16"),
    ("eval step", 8, 16, 128, "float32"),
    ("32-view f32", 4, 32, 128, "float32"),
    ("batch-32 bf16", 32, 16, 128, "bfloat16"),
    ("batch-1 latency", 1, 32, 128, "float32"),
]
JAX_COUNTS = {"forward": jax_flops.hrnet_forward_flops, "train_step": jax_flops.train_step_flops,
              "eval_step": jax_flops.eval_step_flops}

TINY_NET = {
    "encoder": {"in_channels": 2, "num_layers": 1, "kernel_size": 3, "channel_size": 8},
    "recursive": {"alpha_residual": True, "in_channels": 8, "kernel_size": 3},
    "decoder": {
        "deconv": {"in_channels": 8, "kernel_size": 3, "stride": 3, "out_channels": 8},
        "final": {"in_channels": 8, "kernel_size": 1, "out_channels": 1},
    },
}


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


def tiny_config() -> dict:
    cfg = copy.deepcopy(DEFAULT_CONFIG)
    cfg["network"] = copy.deepcopy(TINY_NET)
    cfg["training"]["register_size"] = 32  # ShiftNet on 32 px crops of a 48 px SR
    return cfg


def jax_params(net: dict):
    """The JAX bench's shared init (bench.py:84-98) for ``net``."""
    variables = jax.jit(JaxHRNet(config=net).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 32, 32), jnp.float32),
        jnp.ones((1, 2), jnp.float32))
    return jax.tree_util.tree_map(np.asarray, variables["params"])


# --------------------------------------------------------------------------
# the command line


def run_cli(args: list, cwd: Path) -> subprocess.CompletedProcess:
    env = {**os.environ, "OMP_NUM_THREADS": str(THREADS), "PYTHONPATH": str(REPO)}
    return subprocess.run([sys.executable, "-m", "highresnet_tpu_torch.bench", *args], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=300)


def test_smoke_cli_prints_the_four_keys_and_writes_only_to_out(tmp_path):
    root_details = (REPO / "BENCH_DETAILS.json").read_bytes()
    out = tmp_path / "details" / "bench.json"
    proc = run_cli(["--smoke", "--device", "cpu", "--out", str(out)], REPO)
    assert proc.returncode == 0, proc.stderr
    payload = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(payload) == KEYS and payload["value"] > 0
    details = json.loads(out.read_text())
    (row,) = details["configs"]
    assert details["device"] == "cpu" and row["name"] == "smoke"
    assert row["scenes_per_sec"] == pytest.approx(payload["value"], abs=1e-3)
    assert (REPO / "BENCH_DETAILS.json").read_bytes() == root_details
    assert not list(tmp_path.glob("*.tmp")) and not (REPO / "BENCH_DETAILS.json.tmp").exists()
    # the default lands under build/bench/, never on the JAX bench's record
    assert bench.DEFAULT_OUT == REPO / "build" / "bench" / "BENCH_DETAILS.json"


def test_cli_refuses_full_rows_on_the_cpu_and_a_missing_card(monkeypatch, tmp_path):
    with pytest.raises(SystemExit) as e:
        bench.main(["--device", "cpu", "--out", str(tmp_path / "d.json")])
    assert e.value.code == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--smoke", "--out", str(tmp_path / "d.json")])
    assert not (tmp_path / "d.json").exists()


# --------------------------------------------------------------------------
# the rows against the JAX bench


def test_rows_equal_the_jax_bench():
    got = [(r.name, r.batch, r.views, r.size, r.dtype) for r in (bench.SMOKE_ROW, *bench.ROWS)]
    assert got == JAX_ROWS
    kinds = {r.name: r.kind for r in bench.ROWS}
    assert [n for n, k in kinds.items() if k != "forward"] == [
        "train step f32", "train step bf16", "eval step"]
    assert kinds["eval step"] == "eval_step" and kinds["train step bf16"] == "train_step"
    # the windows are the JAX bench's k2 - k1
    assert [r.iters for r in bench.ROWS] == [20, 20, 10, 10, 10, 20, 10, 100]


@pytest.mark.parametrize("row", (bench.SMOKE_ROW, *bench.ROWS), ids=lambda r: r.name)
def test_row_flops_equal_jax(row):
    """Counts equal at every row; the bases differ (the port rates on the
    H100's peaks)."""
    want = JAX_COUNTS[row.kind](JAX_DEFAULT_CONFIG["network"], row.batch, row.views, row.size)
    assert bench.row_flops(row, DEFAULT_CONFIG["network"]) == want


def test_smoke_forward_equals_jax_apply():
    """The bench's inputs and forward at the smoke shape, full width, on the
    JAX bench's shared init carried over with models/convert.py."""
    net = JAX_DEFAULT_CONFIG["network"]
    params = jax_params(net)
    row = bench.SMOKE_ROW
    rng = np.random.default_rng(0)  # bench.py:114-116
    jax_lrs = jnp.asarray(rng.random((row.batch, row.views, row.size, row.size)), jnp.float32)
    jax_alphas = jnp.ones((row.batch, row.views), jnp.float32)
    want = np.asarray(JaxHRNet(config=net).apply({"params": params}, jax_lrs, jax_alphas))

    lrs, alphas = bench.forward_inputs(row, "cpu")
    assert np.array_equal(lrs.numpy(), np.asarray(jax_lrs))
    model = HRNet(DEFAULT_CONFIG["network"])
    model.load_state_dict(hrnet_state_dict_from_flax(params))
    got = bench.forward(model, lrs, alphas).numpy()
    assert got.shape == want.shape == (1, 48, 48)
    # rtol 1e-5 of the output's scale: an element near zero differs by a few
    # 1e-7 in absolute terms, as any two f32 conv orders do
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_eval_row_scores_equal_jax_eval_step():
    """The eval row's step at a tiny width, on JAX's weights and the bench's
    inputs, against JAX's build_eval_step."""
    from highresnet_tpu.train.step import build_eval_step as jax_eval_step
    from highresnet_tpu_torch.train.step import build_eval_step

    row = bench.Row("eval", "eval_step", 2, 4, 16)
    params = jax_params(TINY_NET)
    lrs, alphas, hrs, maps = bench.scored_inputs(row, "cpu")
    rng = np.random.default_rng(0)  # bench.py:231-235
    jax_args = [jnp.asarray(rng.random((2, 4, 16, 16)), jnp.float32), jnp.ones((2, 4)),
                jnp.asarray(rng.random((2, 48, 48)), jnp.float32), jnp.ones((2, 48, 48))]
    assert np.array_equal(hrs.numpy(), np.asarray(jax_args[2]))
    cfg = {**JAX_DEFAULT_CONFIG, "network": TINY_NET}
    _, want = jax_eval_step(JaxHRNet(config=TINY_NET), cfg)(params, *jax_args)

    model = HRNet(TINY_NET)
    model.load_state_dict(hrnet_state_dict_from_flax(params))
    _, got = build_eval_step(model)(dict(model.named_parameters()), lrs, alphas, hrs, maps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


# --------------------------------------------------------------------------
# the rows on the CPU at a tiny width


def test_train_and_eval_rows_run_at_a_tiny_width():
    b = bench.Bench(torch.device("cpu"), config=tiny_config(), iters=2, repeats=2)
    rows = [bench.Row("train step f32", "train_step", 2, 4, 16),
            bench.Row("train step bf16", "train_step", 2, 4, 16, "bfloat16"),
            bench.Row("eval step", "eval_step", 2, 4, 16)]
    results = [b.run(row) for row in rows]
    for row, got in zip(rows, results):
        assert got["name"] == row.name and got["step_time_s"] > 0
        assert got["scenes_per_sec"] == pytest.approx(row.batch / got["step_time_s"])
        assert got["flops"] == bench.row_flops(row, TINY_NET)
        assert got["launches"] == {"pack": 0, "unpack": 0}  # the plain versions on the CPU
        assert "timing_suspect" not in got and got["peak_memory_gb"] is None
    f32, bf16, ev = results
    for got in (f32, bf16):
        assert got["patch"] == 16 and np.isfinite(got["last_loss"])
        assert got["steps"] == 1 + 2 * (1 + 2)  # the first call, then warm-up + window twice
        assert got["state_dtypes"] == {k: ["float32"] for k in ("params", "grads", "adam_moments")}
        assert got["projected_400epoch_1160scene_hours"] == pytest.approx(
            400 * 1160 * got["step_time_s"] / 2 / 3600)
    assert ev["first_scores_finite"] and ev["lr_size"] == 16
    startup = b.details["startup"]  # written by the f32 train row only
    assert startup["init_time_s"] == f32["init_time_s"]
    assert startup["first_step_s"] == round(f32["first_call_s"], 3)
    assert 0 < startup["process_start_to_first_step_s"]


def test_a_failing_row_is_recorded_and_the_next_runs(tmp_path, monkeypatch, capsys):
    b = bench.Bench(torch.device("cpu"), config=tiny_config(), iters=1, repeats=1)
    b.details["configs"] = []
    real = bench.Bench.row_forward

    def refuse_bf16(self, row):
        if row.dtype == "bfloat16":
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 40 GiB")
        return real(self, row)

    monkeypatch.setattr(bench.Bench, "row_forward", refuse_bf16)
    rows = (bench.Row("headline", "forward", 1, 2, 16),
            bench.Row("bf16", "forward", 1, 2, 16, "bfloat16"),
            bench.Row("after", "forward", 1, 4, 16))
    out = tmp_path / "d.json"
    bench.run_rows(b, rows, out)
    written = json.loads(out.read_text())["configs"]
    assert [r["name"] for r in written] == ["headline", "bf16", "after"]
    assert written[1]["error"] == "OutOfMemoryError: CUDA out of memory. Tried to allocate 40 GiB"
    assert "error" not in written[2] and written[2]["step_time_s"] > 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == KEYS
    assert line["vs_baseline"] == pytest.approx(line["value"] / 10.0, abs=1e-3)


def test_process_age_counts_from_process_start():
    age = time.perf_counter() - bench._T_PROC0
    assert 0 < age < 24 * 3600


# --------------------------------------------------------------------------
# the research-queue scripts

SCRIPTS = ("run_ft_rponly.sh", "run_round5_queue.sh")
SHIM = """#!/bin/sh
# records each driver call instead of running it; a training leg leaves the
# run dir a completed driver would (best/ and best_score.json)
if [ "$1" = "-" ]; then exec "$REAL_PYTHON" "$@"; fi
exec "$REAL_PYTHON" - "$@" <<'PY'
import json, os, sys
argv = sys.argv[1:]
with open(os.environ["LEG_LOG"], "a") as f:
    f.write(json.dumps(argv) + "\\n")
if "--run-name" in argv:
    run = os.path.join(argv[argv.index("--root") + 1], "ckpt", argv[argv.index("--run-name") + 1])
    os.makedirs(os.path.join(run, "best"), exist_ok=True)
    with open(os.path.join(run, "best_score.json"), "w") as f:
        json.dump(json.loads(os.environ.get("BEST_SCORE", '{"score": -17.0, "epoch": 53}')), f)
PY
"""


@pytest.fixture
def queue(tmp_path):
    """A copy of the scripts in a scratch tree, a ``python`` on PATH that
    records the legs, and $TMPDIR in the scratch tree."""
    tree = tmp_path / "tree" / "highresnet_tpu_torch" / "examples"
    tree.mkdir(parents=True)
    for name in SCRIPTS:
        shutil.copy2(REPO / "highresnet_tpu_torch" / "examples" / name, tree / name)
    shim = tmp_path / "bin" / "python"
    shim.parent.mkdir()
    shim.write_text(SHIM)
    shim.chmod(0o755)
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    log = tmp_path / "legs.jsonl"
    env = {**os.environ, "PATH": f"{shim.parent}{os.pathsep}{os.environ['PATH']}",
           "REAL_PYTHON": sys.executable, "LEG_LOG": str(log), "TMPDIR": str(tmp)}

    def run(name: str, *args: str, **extra_env) -> tuple[int, list, str]:
        """Run a script; an ``extra_env`` value of None unsets that variable."""
        log.write_text("")
        run_env = {k: v for k, v in {**env, **extra_env}.items() if v is not None}
        proc = subprocess.run(["bash", str(tree / name), *args], env=run_env,
                              capture_output=True, text=True, timeout=120)
        legs = [json.loads(line) for line in log.read_text().splitlines()]
        return proc.returncode, legs, proc.stdout + proc.stderr

    return run, tmp_path / "tree", tmp / "hrn_varl_data"


def parses(legs: list, monkeypatch) -> list:
    """Each leg's flags through its driver's parser: the driver parses, then
    stops at device setup (no data, no training)."""
    from highresnet_tpu_torch import runtime

    class Parsed(Exception):
        pass

    def stop(device):
        raise Parsed(device)

    monkeypatch.setattr(runtime, "setup_device", stop)
    names = []
    for argv in legs:
        assert argv[0] == "-m" and argv[1].startswith("highresnet_tpu_torch.examples.")
        module = importlib.import_module(argv[1])
        with pytest.raises(Parsed):
            module.main(argv[2:])
        names.append(argv[1].rsplit(".", 1)[1])
    return names


@pytest.mark.parametrize("name", SCRIPTS)
def test_queue_script_passes_bash_n_and_points_at_the_port(name):
    path = REPO / "highresnet_tpu_torch" / "examples" / name
    assert subprocess.run(["bash", "-n", str(path)]).returncode == 0
    sh = path.read_text()
    assert "supervise_tpu" not in sh and "examples/quality_experiment.py" not in sh
    assert not [w for w in sh.split() if w.startswith("/")]  # no absolute path
    assert "/tmp" not in sh  # not even as the fallback of an unset TMPDIR
    assert "RECIPE_" in sh
    assert os.access(path, os.X_OK)


def test_run_ft_rponly_legs_and_the_fixl_cross_check(queue, monkeypatch):
    run, tree, root = queue
    rc, legs, out = run("run_ft_rponly.sh", "--device", "cpu")
    assert rc == 0, out
    assert parses(legs, monkeypatch) == ["quality_experiment", "quality_experiment"]
    regen, ft = legs
    assert regen[regen.index("--run-name") + 1] == "fixL" and "--init-from" not in regen
    assert ft[ft.index("--init-from") + 1] == str(root / "ckpt" / "fixL")
    assert ft[ft.index("--range-penalty") + 1] == "10" and ft[-2:] == ["--device", "cpu"]
    for leg in legs:
        assert leg[leg.index("--root") + 1] == str(root)
        assert leg[leg.index("--out") + 1].startswith("build/examples/")
    assert "recorded as the first" in out
    first = json.loads((root / "ckpt" / "fixL_first_best_score.json").read_text())
    assert first == {"score": -17.0, "epoch": 53}

    rc, legs, out = run("run_ft_rponly.sh")  # the base is kept: no regen leg
    assert rc == 0 and "fixL base verified" in out
    assert [leg[leg.index("--run-name") + 1] for leg in legs] == ["ft_rponly"]

    shutil.rmtree(root / "ckpt" / "fixL")  # a regenerated base that differs stops the script
    rc, legs, out = run("run_ft_rponly.sh", BEST_SCORE='{"score": -16.0, "epoch": 41}')
    assert rc != 0 and "fixL base mismatch" in out
    assert [leg[leg.index("--run-name") + 1] for leg in legs] == ["fixL"]


@pytest.mark.parametrize("name", SCRIPTS)
def test_queue_script_without_tmpdir_keeps_its_data_in_the_checkout(queue, name):
    run, tree, _ = queue
    rc, legs, out = run(name, TMPDIR=None)
    assert rc == 0, out
    roots = {leg[leg.index("--root") + 1] for leg in legs}
    assert [os.path.realpath(r) for r in roots] == [
        os.path.realpath(tree / "build" / "hrn_varl_data")]


def test_run_round5_queue_legs(queue, monkeypatch):
    run, tree, root = queue
    rc, legs, out = run("run_round5_queue.sh", "--device", "cpu")
    assert rc == 0 and "round-5 queue complete" in out, out
    names = parses(legs, monkeypatch)
    assert names == ["views_ablation", "quality_experiment", "quality_experiment",
                     "views_ablation"] + ["quality_experiment", "views_ablation"] * 2
    runs = [leg[leg.index("--run-name") + 1] for leg in legs if "--run-name" in leg]
    assert runs == ["ft_ctl", "varL_ft_from_rp", "ft_rp30", "ft_rp100"]
    checkpoints = [leg[leg.index("--checkpoint") + 1] for leg in legs if "--checkpoint" in leg]
    assert checkpoints == [str(root / "ckpt" / r) for r in
                           ("ft_rponly", "varL_ft_from_rp", "ft_rp30", "ft_rp100")]
    for leg in legs:
        assert leg[-2:] == ["--device", "cpu"]
        assert leg[leg.index("--out") + 1].startswith("build/examples/")
    # the first curve is skipped once its report exists
    (tree / "build" / "examples" / "VIEWS_ABLATION_FT_RPONLY.json").write_text("{}")
    rc, legs, _ = run("run_round5_queue.sh")
    assert rc == 0 and len(legs) == 7
