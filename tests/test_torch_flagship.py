"""The measured-best recipe through the port, against the JAX package.

- ``hr_crop_pool`` byte for byte; one ShiftNet warm-start step from the same
  weights on the same drawn crops and offsets (the JAX step's draws are
  injected: jax.random and torch.Generator cannot agree), dropout off, at
  ``warp_int_range`` 0 and 4; an end-to-end warm-start that recovers a
  held-out offset (the twin of ``tests/test_train.py``'s).
- ``training.init_params_from``: the donor's ``best/`` exactly, fresh Adam
  moments, the EMA at the loaded point; a JAX run dir after
  ``scripts/export_torch_weights.py``, every tensor bit for bit;
  ``training.epoch_cache_variants``:
  the cache built under the JAX package's key, then replayed.
- The arc: ``configs/flagship.json``, ``flagship_ft_rp.json`` and
  ``flagship_ft_varl.json`` chained through ``--run-dir`` in the port's
  ``cli.train`` on a tiny misaligned synthetic set, then ``cli.predict``
  with ``--tta 8``, ``--registered``, two checkpoints, and ``--top-k 1``
  (every scene single-view, so the bicubic route). The configs run as
  shipped apart from these cuts for the CPU: paths; epochs 2 / 1 / 1;
  ``register_warmup_epochs`` 1, so both the unregistered and the registered
  step run; the warm-start's 400 steps cut to 10; batch 32 -> 4; 16 views
  -> 4; val proportion 0.1 -> 0.25; 2 loader workers.
"""

import contextlib
import copy
import io
import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import highresnet_tpu.train.pretrain as jax_pretrain
from highresnet_tpu.models import ShiftNet as JaxShiftNet
from highresnet_tpu.models.convert import shiftnet_from_torch
from highresnet_tpu_torch.config import load_config
from highresnet_tpu_torch.data import discover_scenes, make_synthetic_dataset
from highresnet_tpu_torch.models import ShiftNet
from highresnet_tpu_torch.ops.lanczos import lanczos_shift
from highresnet_tpu_torch.train import pretrain
from highresnet_tpu_torch.train.state import make_optimizer
from test_torch_train import jax_float64

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RS = 32
STEP_RTOL = 1e-5  # loss, BN statistics
PARAM_TOL = 1e-5  # |dp| after the Adam step, relative to that tensor's norm
GRAD_TOL = 1e-4  # max |dg| per tensor, relative to the whole gradient's norm
LR = 1e-4
TINY = {
    "network": {
        "encoder": {"in_channels": 2, "num_layers": 1, "kernel_size": 3, "channel_size": 8},
        "recursive": {"alpha_residual": True, "in_channels": 8, "kernel_size": 3},
        "decoder": {
            "deconv": {"in_channels": 8, "kernel_size": 3, "stride": 3, "out_channels": 8},
            "final": {"in_channels": 8, "kernel_size": 1, "out_channels": 1},
        },
    },
    "training": {
        "batch_size": 2, "min_L": 4, "n_views": 4, "crop": 1, "lr": 1e-3, "lr_step": 2,
        "lr_decay": 0.97, "beta": 50.0, "create_patches": True, "patch_size": 16,
        "register_size": 32, "val_proportion": 0.34, "lambda": 1e-6, "num_epochs": 1,
        "n_workers": 1, "seed": 0, "eval_batch_size": 2,
    },
    "paths": {"prefix": "", "checkpoint_dir": "", "tb_log_file_dir": ""},
}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs files side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def train_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("flagship_small")
    make_synthetic_dataset(str(root), n_scenes_per_channel=2, n_views=5, lr_size=16, seed=0,
                           splits=("train",), hr_shift_sigma=1.25)
    return str(root)


def _tiny(root, tmp, **training):
    cfg = copy.deepcopy(TINY)
    cfg["training"].update(training)
    cfg["paths"].update(prefix=root, checkpoint_dir=str(tmp / "runs"))
    return cfg


# --- the warm-start ------------------------------------------------------------


def test_hr_crop_pool_matches_jax(train_root):
    scenes = discover_scenes(f"{train_root}/train")
    got = pretrain.hr_crop_pool(scenes, RS)
    want = jax_pretrain.hr_crop_pool(scenes, RS)
    assert got.dtype == want.dtype == np.float32 and got.shape == (len(scenes), RS, RS)
    assert got.tobytes() == want.tobytes()
    assert pretrain.hr_crop_pool(scenes, RS, max_scenes=2).tobytes() == want[:2].tobytes()
    with pytest.raises(ValueError, match="no usable HR crops"):
        pretrain.hr_crop_pool(scenes, 64)


def _random_shiftnet(seed: int) -> ShiftNet:
    model = ShiftNet(register_size=RS, generator=torch.Generator().manual_seed(seed))
    model.dropout = 0.0
    rng = np.random.default_rng(seed)
    with torch.no_grad():  # a nonzero fc2, so the loss's gradient reaches every layer
        model.fc2.weight.copy_(torch.from_numpy(rng.normal(0, 0.02, (2, 1024)).astype(np.float32)))
    return model


class _AddGrad(torch.optim.Optimizer):
    """p <- p + g: the updated parameters carry the step's gradient."""

    def __init__(self, params):
        super().__init__(params, {})

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                p.add_(p.grad)


def _jax_warmstart(model, pool, idx, d, max_shift, warp_int_range, monkeypatch, capture):
    """JAX's pretrain_shiftnet in float64 (``test_torch_train.jax_float64``:
    its pairs warped from the pool in float64 too) for one step from the
    port model's weights, its draws replaced by idx and d (sigma 1: d = 1 *
    normal), dropout off; with ``capture`` optax.adam is replaced by an
    update that is the gradient. At the port's init a pair warped in f32 by
    either package's warp sits an ulp from the other's, and ReLU inputs
    within rounding of zero carry that into the conv gradients: JAX's own f32
    step lies further from this float64 one than the port's f32 step does."""
    params, stats = shiftnet_from_torch(
        {k: v.double() if v.is_floating_point() else v for k, v in model.state_dict().items()})
    monkeypatch.setattr(jax.random, "randint", lambda *a, **k: jnp.asarray(idx))
    monkeypatch.setattr(jax.random, "normal", lambda *a, **k: jnp.asarray(d))
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    if capture:
        monkeypatch.setattr(jax_pretrain.optax, "adam", lambda lr: optax.GradientTransformation(
            lambda p: (), lambda u, s, p=None: (u, s)))
    try:
        with jax_float64(monkeypatch):
            return jax.device_get(jax_pretrain.pretrain_shiftnet(
                JaxShiftNet(dtype=jnp.float64), params, stats, pool, jax.random.PRNGKey(0),
                steps=1, sigma=1.0, max_shift=max_shift, lr=LR, batch_size=len(idx),
                warp_int_range=warp_int_range))
    finally:
        monkeypatch.undo()


def _feeds_batchnorm(path: str) -> bool:
    """A conv bias before a BatchNorm: its gradient is zero in exact
    arithmetic, so both sides hold rounding noise."""
    return path.startswith("['conv") and path.endswith("['bias']")


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v))
            for p, v in jax.tree_util.tree_leaves_with_path(tree)]


@pytest.mark.parametrize("warp_int_range, fused", [
    pytest.param(0, False, id="0"),
    pytest.param(4, False, id="4"),
    pytest.param(0, True, id="0-use_pallas_warp"),  # the fused warp's CPU path
])
def test_warmstart_step_matches_jax(warp_int_range, fused, train_root, monkeypatch):
    """One step on injected draws, dropout off on both sides (hazard H3):
    loss, the step's gradients (read through an update that is the gradient),
    BatchNorm statistics, and the parameters after the real Adam step."""
    pool = pretrain.hr_crop_pool(discover_scenes(f"{train_root}/train"), RS)
    rng = np.random.default_rng(warp_int_range)
    idx = rng.integers(0, len(pool), 8).astype(np.int32)
    max_shift = warp_int_range + 0.5 if warp_int_range else 3.0
    d = rng.uniform(-max_shift, max_shift, (8, 2)).astype(np.float32)
    args = (torch.from_numpy(pool), torch.from_numpy(idx), torch.from_numpy(d), None,
            warp_int_range, fused)

    before = _random_shiftnet(warp_int_range)
    p0 = dict(_leaves(shiftnet_from_torch(before.state_dict())[0]))
    want_p, want_s, rmse = _jax_warmstart(before, pool, idx, d, max_shift, warp_int_range,
                                          monkeypatch, capture=True)
    model = copy.deepcopy(before).train()
    loss = pretrain.pretrain_step(model, _AddGrad(model.parameters()), *args)
    np.testing.assert_allclose(loss.item(), rmse ** 2, rtol=STEP_RTOL)
    got_p, got_s = shiftnet_from_torch(model.state_dict())
    grads = {path: want - p0[path] for path, want in _leaves(want_p)}
    norm = np.sqrt(sum(np.sum(np.square(g)) for g in grads.values()))
    assert [path for path, _ in _leaves(got_p)] == list(grads)
    # against the whole gradient's norm: a ReLU input within rounding of 0
    # (the frameworks' convolutions round apart) opens on one side only and
    # moves that element's cotangent into the layers below it
    for path, got in _leaves(got_p):
        err = np.abs((got - p0[path]) - grads[path]).max()
        assert err <= GRAD_TOL * norm, (path, err)
    for i in range(1, 9):
        for s in ("mean", "var"):
            want = np.asarray(want_s[f"bn{i}"][s])
            np.testing.assert_allclose(got_s[f"bn{i}"][s], want, rtol=STEP_RTOL,
                                       atol=STEP_RTOL * np.abs(want).max(), err_msg=f"bn{i} {s}")

    # the real step: Adam's first update is lr * g / (|g| + eps), nearly lr * sign(g),
    # so an element whose gradient is rounding noise may move the other way (2 lr)
    want_p, _, _ = _jax_warmstart(before, pool, idx, d, max_shift, warp_int_range, monkeypatch,
                                  capture=False)
    model = copy.deepcopy(before).train()
    pretrain.pretrain_step(model, make_optimizer(list(model.parameters()), LR), *args)
    for (path, got), (_, want) in zip(_leaves(shiftnet_from_torch(model.state_dict())[0]),
                                      _leaves(want_p)):
        err = np.abs(got - want)
        assert err.max() <= 2 * LR * (1 + 1e-3), (path, err.max())
        if not _feeds_batchnorm(path):
            assert np.mean(err > PARAM_TOL * np.linalg.norm(want)) <= 1e-3, path


def test_warmstart_recovers_shifts(train_root):
    """After the warm-start, ShiftNet recovers a held-out offset with the sign
    convention the train step's warp consumes (theta = flip(d))."""
    pool = pretrain.hr_crop_pool(discover_scenes(f"{train_root}/train"), RS)
    model = ShiftNet(register_size=RS, generator=torch.Generator().manual_seed(0))
    rmse = pretrain.pretrain_shiftnet(model, pool, torch.Generator().manual_seed(1), steps=150,
                                      sigma=1.0, batch_size=16, lr=3e-4)
    assert rmse < 0.6, rmse  # a zero-initialised ShiftNet predicts 0: RMSE == sigma
    moving = torch.from_numpy(pool[:1])
    d = torch.tensor([[0.8, -0.5]])  # (dy, dx)
    pairs = torch.stack([lanczos_shift(moving, d), moving], dim=1)
    with torch.no_grad():
        theta = model.eval()(pairs)
    err = (theta - torch.flip(d, dims=(-1,))).abs().max().item()
    assert err < 0.5, (theta, err)


# --- init_params_from and the epoch cache --------------------------------------


def test_init_params_from_finetunes_saved_best(train_root, tmp_path, capsys):
    """The twin of tests/test_train.py::test_init_params_from_finetunes_saved_best."""
    from highresnet_tpu_torch.train.checkpoint import CheckpointManager
    from highresnet_tpu_torch.train.loop import train_and_get_best_model
    from highresnet_tpu_torch.train.setup import build_models_and_steps

    donor_dir = str(tmp_path / "donor")
    train_and_get_best_model(_tiny(train_root, tmp_path), run_dir=donor_dir, device="cpu")
    donor = CheckpointManager(donor_dir).load_best()

    cfg = _tiny(train_root, tmp_path, init_params_from=donor_dir, ema_decay=0.99)
    pieces = build_models_and_steps(cfg, torch.device("cpu"), seed=123,
                                    train_list=discover_scenes(f"{train_root}/train"))
    assert f"init: params loaded from {donor_dir}/best" in capsys.readouterr().out
    state = pieces.state
    for name in ("hrnet", "shiftnet"):
        params = dict(getattr(state, name).named_parameters())
        assert params.keys() == donor["params"][name].keys()
        for k, want in donor["params"][name].items():
            assert torch.equal(params[k], want), (name, k)
            assert torch.equal(state.ema[name][k], want), (name, k)
    for k, want in donor["batch_stats"].items():
        assert torch.equal(state.batch_stats[k], want), k
    # fresh optimizer: no Adam moment has left zero (torch creates them at the first step)
    assert all(float(s[m].abs().max()) == 0.0 for s in state.optimizer.state.values()
               for m in ("exp_avg", "exp_avg_sq"))

    out = train_and_get_best_model(_tiny(train_root, tmp_path, init_params_from=donor_dir),
                                   run_dir=str(tmp_path / "finetune"), device="cpu")
    assert np.isfinite(out["best_score"])
    with pytest.raises(FileNotFoundError, match="export_torch_weights"):
        train_and_get_best_model(_tiny(train_root, tmp_path, init_params_from=str(tmp_path)),
                                 run_dir=str(tmp_path / "bad"), device="cpu")


def test_init_params_from_loads_an_exported_jax_run(train_root, tmp_path):
    """A JAX run dir (Orbax best/ from the JAX package's CheckpointManager,
    flax-drawn weights, a random fc2, BN statistics away from (0, 1)) after
    scripts/export_torch_weights.py: init_params_from loads every parameter
    and BatchNorm statistic bit for bit, and the EMA starts there."""
    import importlib.util

    from highresnet_tpu.models import HRNet as JaxHRNet
    from highresnet_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
    from highresnet_tpu_torch.models import hrnet_state_dict_from_flax, shiftnet_state_dict_from_flax
    from highresnet_tpu_torch.train.setup import build_models_and_steps

    rng = np.random.default_rng(4)
    hrnet = jax.device_get(JaxHRNet(config=TINY["network"]).init(
        jax.random.PRNGKey(2), jnp.zeros((1, 4, 16, 16)), jnp.ones((1, 4)))["params"])
    variables = JaxShiftNet().init(jax.random.PRNGKey(3), jnp.zeros((1, RS, RS, 2)), train=False)
    shiftnet = jax.device_get(variables["params"])
    shiftnet["fc2"]["kernel"] = rng.normal(0, 0.05, (1024, 2)).astype(np.float32)
    stats = {name: {"mean": rng.normal(0, 0.1, s["mean"].shape).astype(np.float32),
                    "var": rng.uniform(0.5, 2.0, s["var"].shape).astype(np.float32)}
             for name, s in variables["batch_stats"].items()}
    run_dir = str(tmp_path / "jax_run")
    ckpt = JaxCheckpointManager(run_dir)
    ckpt.save_best({"hrnet": hrnet, "shiftnet": shiftnet}, stats, score=-1.0)
    ckpt.wait()
    config = tmp_path / "config.json"
    config.write_text(json.dumps(_tiny(train_root, tmp_path)))
    spec = importlib.util.spec_from_file_location(
        "export_torch_weights", os.path.join(REPO, "scripts", "export_torch_weights.py"))
    export = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export)
    export.main(["--config", str(config), "--run-dir", run_dir])

    cfg = _tiny(train_root, tmp_path, init_params_from=run_dir, ema_decay=0.99)
    state = build_models_and_steps(cfg, torch.device("cpu"), seed=123,
                                   train_list=discover_scenes(f"{train_root}/train")).state
    want = {"hrnet": hrnet_state_dict_from_flax(hrnet),
            "shiftnet": shiftnet_state_dict_from_flax(shiftnet, stats)}
    for name in ("hrnet", "shiftnet"):
        got = getattr(state, name).state_dict()
        keys = [k for k in got if not k.endswith("num_batches_tracked")]
        assert sorted(keys) == sorted(k for k in want[name] if not k.endswith("num_batches_tracked"))
        for k in keys:
            assert torch.equal(got[k], want[name][k]), (name, k)
        for k, p in getattr(state, name).named_parameters():
            assert torch.equal(state.ema[name][k], p), (name, k)


def test_epoch_cache_in_train_loop(train_root, tmp_path, monkeypatch):
    """The twin of tests/test_data.py::test_epoch_cache_in_train_loop: two
    variants built under the JAX package's key in epochs 1-2, replayed in 3."""
    from highresnet_tpu.train.setup import build_train_loader as jax_build_train_loader
    from highresnet_tpu_torch.data.pipeline import EpochCache
    from highresnet_tpu_torch.data.probav import train_val_split
    from highresnet_tpu_torch.train.loop import train_and_get_best_model

    cfg = _tiny(train_root, tmp_path, epoch_cache_variants=2, num_epochs=3, checkpoint_every=0)
    served = []
    real_serve = EpochCache._serve

    def serve(self, variant):
        served.append(variant)
        yield from real_serve(self, variant)

    monkeypatch.setattr(EpochCache, "_serve", serve)
    out = train_and_get_best_model(cfg, run_dir=str(tmp_path / "run"), device="cpu")
    assert np.isfinite(out["best_score"]) and served == [0]

    t = cfg["training"]
    train_list, _ = train_val_split(discover_scenes(f"{train_root}/train"), t["val_proportion"],
                                    seed=1)
    want = jax_build_train_loader(t, train_list, seed=t["seed"], proc=0, drop_last=False,
                                  data_dir=train_root).cache_dir
    committed = sorted(f for f in os.listdir(want) if f.endswith(".meta.json"))
    assert committed == ["variant000.meta.json", "variant001.meta.json"]
    assert os.path.dirname(want) == os.path.join(train_root, ".epoch_cache")


def _final_state(run_dir):
    with open(os.path.join(run_dir, "latest.json")) as f:
        latest = json.load(f)
    return latest, torch.load(os.path.join(run_dir, latest["slot"], "state.pt"),
                              map_location="cpu", weights_only=True)


def test_epoch_cache_resume_is_bit_identical(train_root, tmp_path):
    """1 epoch, then a resume to 3, with two cache variants: the resumed run
    builds variant 1 in epoch 2 from the sampling an uninterrupted run draws
    there, so it ends bit-identical to 3 epochs straight. Each run has a
    cache of its own, so neither replays what the other built."""
    from highresnet_tpu_torch.train.loop import train_and_get_best_model

    def run(run_dir, cache_dir, epochs):
        cfg = _tiny(train_root, tmp_path, epoch_cache_variants=2, num_epochs=epochs,
                    checkpoint_every=0, epoch_cache_dir=str(tmp_path / cache_dir))
        train_and_get_best_model(cfg, run_dir=str(tmp_path / run_dir), device="cpu")

    run("resumed", "cache_resumed", 1)
    assert _final_state(str(tmp_path / "resumed"))[0]["epoch"] == 1
    run("resumed", "cache_resumed", 3)
    run("straight", "cache_straight", 3)
    latest_a, a = _final_state(str(tmp_path / "resumed"))
    latest_b, b = _final_state(str(tmp_path / "straight"))
    assert latest_a["epoch"] == latest_b["epoch"] == 3
    assert latest_a["val_history"] == latest_b["val_history"]
    assert a["step"] == b["step"] > 0
    for model in ("hrnet", "shiftnet"):
        for k in a[model]:
            assert torch.equal(a[model][k], b[model][k]), (model, k)
    for sa, sb in zip(a["optimizer"]["state"].values(), b["optimizer"]["state"].values()):
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert torch.equal(a["generator"], b["generator"])


# --- the arc --------------------------------------------------------------------


def _stage_config(tmp, name, root, init_from=None, **training):
    cfg = load_config(os.path.join(REPO, "configs", f"{name}.json"))
    cfg["paths"].update(prefix=root, checkpoint_dir=str(tmp / "ckpt"))
    cfg["training"].update(batch_size=4, min_L=4, n_views=4, val_proportion=0.25, n_workers=2,
                           **training)
    if init_from is not None:
        assert cfg["training"]["init_params_from"]  # the shipped config chains
        cfg["training"]["init_params_from"] = init_from
    path = tmp / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.fixture(scope="module")
def arc(tmp_path_factory):
    from highresnet_tpu_torch.cli.train import main as train_main

    tmp = tmp_path_factory.mktemp("arc")
    root = make_synthetic_dataset(str(tmp / "data"), n_scenes_per_channel=4, n_views=5,
                                  lr_size=32, seed=0, hr_shift_sigma=1.25)
    runs = {name: str(tmp / "ckpt" / name)
            for name in ("flagship", "flagship_ft_rp", "flagship_ft_varl")}
    configs = {
        "flagship": _stage_config(tmp, "flagship", root, num_epochs=2,
                                  register_warmup_epochs=1, shiftnet_warmup_steps=10),
        "flagship_ft_rp": _stage_config(tmp, "flagship_ft_rp", root, runs["flagship"],
                                        num_epochs=1),
        "flagship_ft_varl": _stage_config(tmp, "flagship_ft_varl", root, runs["flagship_ft_rp"],
                                          num_epochs=1),
    }
    outs, logs = {}, {}
    for name, path in configs.items():
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            outs[name] = train_main(["--config", path, "--run-dir", runs[name], "--device", "cpu"])
        logs[name] = log.getvalue()
    return {"runs": runs, "configs": configs, "outs": outs, "logs": logs}


def test_flagship_arc_trains_through_the_cli(arc):
    runs, outs, logs = arc["runs"], arc["outs"], arc["logs"]
    assert "shiftnet warm-start: 10 steps on " in logs["flagship"]
    assert "init: params loaded" not in logs["flagship"]
    assert f"init: params loaded from {runs['flagship']}/best" in logs["flagship_ft_rp"]
    assert f"init: params loaded from {runs['flagship_ft_rp']}/best" in logs["flagship_ft_varl"]
    assert "shiftnet warm-start" not in logs["flagship_ft_rp"] + logs["flagship_ft_varl"]
    for name, out in outs.items():
        assert np.isfinite(out["best_score"]) and np.isfinite(out["train_loss"]), name
        with open(os.path.join(runs[name], "latest.json")) as f:
            assert json.load(f)["epoch"] == (2 if name == "flagship" else 1)
        assert os.path.isfile(os.path.join(runs[name], "best", "ShiftNet.pth"))


@pytest.mark.parametrize("mode", ["tta8", "registered", "ensemble", "bicubic"])
def test_flagship_arc_serves_through_the_cli(arc, mode, capsys):
    from highresnet_tpu_torch.cli.predict import main as predict_main

    runs = arc["runs"]
    argv = ["--config", arc["configs"]["flagship_ft_varl"], "--splits", "train", "val",
            "--device", "cpu", "--checkpoint"]
    argv += {"tta8": [runs["flagship_ft_varl"], "--tta", "8"],
             "registered": [runs["flagship_ft_varl"], "--registered"],
             "ensemble": [runs["flagship_ft_rp"], runs["flagship_ft_varl"]],
             "bicubic": [runs["flagship_ft_varl"], "--top-k", "1"]}[mode]
    table = predict_main(argv)
    scores = table["model"].astype(float)
    assert len(scores) == 8 and np.isfinite(scores).all()
    printed = capsys.readouterr().out
    assert all(name in printed for name in table.index)
