"""The port's training slice against the JAX package, at TINY_CONFIG's size
(tests/test_train.py: channels 8, patch 16, register 32, batch 2, L 4).

- One train step from the same converted weights and batch, dropout off on
  both sides (the frameworks' masks cannot agree): loss, thetas, gradients,
  BatchNorm statistics and grad_norm. The JAX step's gradients are read by
  giving it an optimizer whose state becomes the gradient.
- The optimizer and the global-norm clip against optax on identical
  gradients (Adam's first steps are nearly lr·sign(g), so post-step
  parameters of two frameworks are not compared element by element).
- ReduceLROnPlateau, the eval step and the warp-window guard against JAX.
- ``cli.train`` end to end on the CPU: 1 epoch, then a resume to 2, is
  bit-identical to an uninterrupted 2-epoch run; the run directory serves
  through ``cli.predict``.
- F1: under bf16 compute every HRNet parameter and gradient stays f32;
  ``configs/config_tpu_bf16.json`` takes its unregistered and its registered
  step through the port with its training keys as they are.
- The steps run at the port's own init (flax's lecun-normal scale, zero
  biases). The reference for their gradients is JAX's step run in float64
  (``jax_float64``): at this scale the f32 rounding of JAX's own step
  leaves its float64 run by up to 2e-4 of a fusion PReLU gradient's norm,
  more than ``GRAD_TOL``, while the port's f32 step stays within 2e-5 of
  it. The same steps with both packages in float64 (``port_float64``)
  agree to ``F64_TOL``: the witness that the two compute one function.
"""

import contextlib
import copy
import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import highresnet_tpu.models.hrnet as jax_hrnet_module
import highresnet_tpu.models.shiftnet as jax_shiftnet_module
import highresnet_tpu.ops.metrics as jax_metrics
import highresnet_tpu.train.pretrain as jax_pretrain
import highresnet_tpu.train.state as jax_state
import highresnet_tpu.train.step as jax_step
import highresnet_tpu_torch.models.hrnet as port_hrnet_module
import highresnet_tpu_torch.ops.metrics as port_metrics
import highresnet_tpu_torch.train.pretrain as port_pretrain
from highresnet_tpu.data import BatchLoader, collate, discover_scenes, read_imageset
from highresnet_tpu.data.synth import make_synthetic_dataset
from highresnet_tpu.models import HRNet as JaxHRNet
from highresnet_tpu.models import ShiftNet as JaxShiftNet
from highresnet_tpu.models.convert import hrnet_params_from_torch, shiftnet_from_torch
from highresnet_tpu.train.state import TrainState as JaxTrainState
from highresnet_tpu.train.state import make_optimizer as jax_make_optimizer
from highresnet_tpu_torch.models.layers import BatchNorm2d
from highresnet_tpu_torch.train import step as port_step
from highresnet_tpu_torch.train.state import clip_by_global_norm_, create_train_state, global_norm
from highresnet_tpu_torch.train.state import make_optimizer as port_make_optimizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CONFIG = {
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
        "n_workers": 2, "seed": 0, "eval_batch_size": 2,
    },
    "paths": {"prefix": "", "checkpoint_dir": "", "tb_log_file_dir": ""},
}
STEP_RTOL = 1e-5  # loss, grad_norm, BN statistics
GRAD_TOL = 1e-4  # max |Δg| per tensor, relative to that tensor's norm
F64_TOL = 1e-9  # the same, both packages in float64


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs files side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def train_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainset")
    make_synthetic_dataset(str(root), n_scenes_per_channel=2, n_views=5, lr_size=24, seed=0,
                           splits=("train",))
    return str(root)


@pytest.fixture(scope="module")
def batch(train_root):
    loader = BatchLoader(discover_scenes(f"{train_root}/train"), batch_size=2, min_l=4, top_k=4,
                         beta=50.0, create_patches=True, patch_size=16, seed=0, num_workers=1,
                         drop_last=True)
    return next(iter(loader))


def _config(train_root=None, **training):
    cfg = copy.deepcopy(TINY_CONFIG)
    cfg["training"].update(training)
    if train_root:
        cfg["paths"]["prefix"] = train_root
    return cfg


class Float64Namespace:
    """A module's ``jnp``, ``torch`` or ``np`` with its ``float32`` read as
    float64: set as that name in a module, it runs the module's float32
    pins (parameter dtypes, output casts, BatchNorm statistics) in float64."""

    def __init__(self, module, wide):
        self._module, self.float32 = module, wide

    def __getattr__(self, name):
        return getattr(self._module, name)


@contextlib.contextmanager
def jax_float64(monkeypatch):
    """The JAX package in float64 while the block runs: x64 on, and every
    ``jnp.float32`` of the modules the train step, the warm-start and the
    loop reach read as float64. Parameters handed in must be float64."""
    for module in (jax_hrnet_module, jax_shiftnet_module, jax_step, jax_metrics, jax_state,
                   jax_pretrain):
        monkeypatch.setattr(module, "jnp", Float64Namespace(jnp, jnp.float64))
    with jax.enable_x64(True):
        yield


def port_float64(monkeypatch):
    """The port's modules in float64 from here on: HRNet's output cast, the
    warm-start pool and the scores in float64, ``Tensor.float`` (ShiftNet's
    output and BatchNorm's input) the identity on float64, BatchNorm the
    plain one. Models go to float64 through ``state_to_float64``."""
    monkeypatch.setattr(port_hrnet_module, "torch", Float64Namespace(torch, torch.float64))
    monkeypatch.setattr(port_metrics, "torch", Float64Namespace(torch, torch.float64))
    monkeypatch.setattr(port_pretrain, "np", Float64Namespace(np, np.float64))
    to_float = torch.Tensor.float
    monkeypatch.setattr(torch.Tensor, "float", lambda self, *a, **k: (
        self if self.dtype == torch.float64 else to_float(self, *a, **k)))
    monkeypatch.setattr(BatchNorm2d, "forward",
                        lambda self, x: torch.nn.BatchNorm2d.forward(self, x))


@torch.no_grad()
def state_to_float64(state):
    """``state``'s models, their compute dtypes and its EMA in float64."""
    for model in (state.hrnet, state.shiftnet):
        model.to(torch.float64)
        model.dtype = torch.float64
    state.hrnet.decoder_dtype = torch.float64
    if state.ema is not None:
        state.ema = {name: {k: p.detach().clone() for k, p in
                            getattr(state, name).named_parameters()}
                     for name in ("hrnet", "shiftnet")}
    return state


def _port_state(cfg, out_scale: float = 1.0):
    """Seeded port state at the port's init, dropout off, random fc2
    (nonzero thetas)."""
    state = create_train_state(cfg, "cpu", torch.Generator().manual_seed(1))
    state.shiftnet.dropout = 0.0
    rng = np.random.default_rng(3)
    with torch.no_grad():
        state.shiftnet.fc2.weight.copy_(
            torch.from_numpy(rng.normal(0, 0.02, (2, 1024)).astype(np.float32)))
        state.hrnet.decode.final.weight.mul_(out_scale)
    return state


def _jax_step(cfg, hrnet_sd, shiftnet_sd, batch, monkeypatch, float64=False):
    """One JAX train step from the port's weights; returns (metrics, grads,
    batch_stats, thetas) as numpy. The optimizer is swapped for one whose
    state becomes the gradient, and dropout for the identity. With
    ``float64`` the step runs in float64 (``jax_float64``) on the weights
    and the batch widened to float64."""
    if not float64:
        return _jax_step_at(cfg, hrnet_sd, shiftnet_sd, batch, monkeypatch, jnp.float32)
    wide = {k: np.asarray(getattr(batch, k), np.float64) for k in ("lrs", "alphas", "hrs", "hr_maps")}
    with jax_float64(monkeypatch):
        return _jax_step_at(cfg, {k: v.double() for k, v in hrnet_sd.items()},
                            {k: v.double() if v.is_floating_point() else v
                             for k, v in shiftnet_sd.items()},
                            batch._replace(**wide), monkeypatch, jnp.float64)


def _jax_step_at(cfg, hrnet_sd, shiftnet_sd, batch, monkeypatch, dtype=jnp.float32):
    capture = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda u, s, p=None: (jax.tree.map(jnp.zeros_like, u), u),
    )
    monkeypatch.setattr(jax_step, "make_optimizer", lambda *a, **k: capture)
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    n_res = cfg["network"]["encoder"]["num_layers"]
    sn_params, stats = shiftnet_from_torch(shiftnet_sd)
    params = {"hrnet": hrnet_params_from_torch(hrnet_sd, num_res_layers=n_res),
              "shiftnet": sn_params}
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                          opt_state=capture.init(params), rng=jax.random.PRNGKey(0))
    hrnet, shiftnet = JaxHRNet(config=cfg["network"], dtype=dtype), JaxShiftNet(dtype=dtype)
    step = jax_step.build_train_step(hrnet, shiftnet, cfg)
    new, metrics = step(state, batch.lrs, batch.alphas, batch.hrs, batch.hr_maps)
    # the step's thetas: the same train-mode ShiftNet call on the same crops
    t = cfg["training"]
    srs = hrnet.apply({"params": params["hrnet"]}, batch.lrs, batch.alphas)
    off, rs = (3 * t["patch_size"] - t["register_size"]) // 2, t["register_size"]
    pairs = jnp.stack([batch.hrs[:, off:off + rs, off:off + rs],
                       srs[:, off:off + rs, off:off + rs]], axis=-1)
    thetas, _ = shiftnet.apply({"params": sn_params, "batch_stats": stats}, pairs, train=True,
                               rngs={"dropout": jax.random.PRNGKey(1)}, mutable=["batch_stats"])
    return jax.device_get((metrics, new.opt_state, new.batch_stats, thetas))


# gradients that are zero in exact arithmetic, so both sides hold rounding
# noise: conv biases that feed a BatchNorm, and the SR's output bias under
# the bias-corrected criteria (a uniform SR offset leaves cMSE unchanged)
def _zero_in_exact_arithmetic(path: str, loss: str) -> bool:
    if path.startswith("['shiftnet']['conv") and path.endswith("['bias']"):
        return True
    return loss != "masked_MSE" and path == "['hrnet']['decode']['final_conv']['bias']"


STEP_CASES = {
    "registered": {},
    "unregistered": {"register": False},
    "range_penalty": {"range_penalty": 7.0},
    "cMSE_fused_warp": {"loss": "cMSE", "use_pallas_warp": True},
    "int_range": {"warp_int_range": 4},
}  # masked_MSE's values and gradients are held in test_torch_losses.py


def _port_step(cfg, state, batch, monkeypatch):
    """One port step; returns (state, metrics, the thetas its warp took)."""
    seen = {}
    real = port_step.register_and_warp

    def spy(*args, **kwargs):
        warped, thetas = real(*args, **kwargs)
        seen["thetas"] = thetas.detach().double().numpy().copy()
        return warped, thetas

    monkeypatch.setattr(port_step, "register_and_warp", spy)
    dtype = next(state.hrnet.parameters()).dtype
    args = [torch.from_numpy(a).to(dtype) for a in
            (batch.lrs, batch.alphas, batch.hrs, batch.hr_maps)]
    state, m = port_step.build_train_step(cfg)(state, *args)
    monkeypatch.undo()
    return state, m, seen.get("thetas")


def _assert_step_matches(cfg, state, m, thetas, want, grad_tol, rtol):
    """The port's step (its state after the step, metrics and thetas)
    against JAX's ``want`` from ``_jax_step``: loss and grad_norm within
    ``rtol``; every gradient within ``grad_tol`` of its tensor's norm (of the
    whole gradient's for those zero in exact arithmetic); the thetas and the
    mean shift within ``10 * rtol``; BatchNorm statistics within ``rtol``
    (with an atol of ``rtol`` times the tensor's largest element: a mean
    near zero is a sum that cancels)."""
    want_m, want_g, want_stats, want_thetas = want
    assert state.step == 1
    np.testing.assert_allclose(m["loss"].item(), float(want_m["loss"]), rtol=rtol)
    np.testing.assert_allclose(m["grad_norm"].item(), float(want_m["grad_norm"]), rtol=rtol)
    if cfg["training"].get("register", True):
        np.testing.assert_allclose(thetas, want_thetas, rtol=10 * rtol, atol=0.1 * rtol)
        assert np.abs(want_thetas).max() > 0.05  # the warp saw real shifts
    else:
        assert thetas is None and m["max_abs_shift"].item() == 0.0
    np.testing.assert_allclose(m["mean_abs_shift"].item(), float(want_m["mean_abs_shift"]),
                               rtol=10 * rtol, atol=0.01 * rtol)

    n_res = cfg["network"]["encoder"]["num_layers"]
    grads = {
        "hrnet": hrnet_params_from_torch(
            {k: p.grad for k, p in state.hrnet.named_parameters()}, num_res_layers=n_res),
        "shiftnet": shiftnet_from_torch(
            {**{k: p.grad for k, p in state.shiftnet.named_parameters()},
             **dict(state.shiftnet.named_buffers())})[0],
    }
    got_leaves = jax.tree_util.tree_leaves_with_path(grads)
    want_leaves = jax.tree_util.tree_leaves_with_path(want_g)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    norm = float(want_m["grad_norm"])
    loss = cfg["training"].get("loss", "cPSNR")
    for (path, got), (_, want) in zip(got_leaves, want_leaves):
        path, want = jax.tree_util.keystr(path), np.asarray(want, np.float64)
        err = np.abs(np.asarray(got, np.float64) - want).max()
        if _zero_in_exact_arithmetic(path, loss):
            assert err <= grad_tol * norm, (path, err)
        else:
            assert err <= grad_tol * np.linalg.norm(want), (path, err, np.linalg.norm(want))

    _, got_stats = shiftnet_from_torch(state.shiftnet.state_dict())
    for i in range(1, 9):
        for s in ("mean", "var"):
            want = np.asarray(want_stats[f"bn{i}"][s])
            np.testing.assert_allclose(got_stats[f"bn{i}"][s], want, rtol=rtol,
                                       atol=rtol * np.abs(want).max(), err_msg=f"bn{i} {s}")


def _step_inputs(case):
    cfg = _config(**STEP_CASES[case])
    state = _port_state(cfg, out_scale=8.0 if case == "range_penalty" else 1.0)
    hrnet_sd = {k: v.clone() for k, v in state.hrnet.state_dict().items()}
    shiftnet_sd = {k: v.clone() for k, v in state.shiftnet.state_dict().items()}
    return cfg, state, hrnet_sd, shiftnet_sd


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_matches_jax(case, batch, monkeypatch):
    """The port's f32 step at its own init against JAX's step in float64."""
    cfg, state, hrnet_sd, shiftnet_sd = _step_inputs(case)
    state, m, thetas = _port_step(cfg, state, batch, monkeypatch)
    want = _jax_step(cfg, hrnet_sd, shiftnet_sd, batch, monkeypatch, float64=True)
    monkeypatch.undo()
    _assert_step_matches(cfg, state, m, thetas, want, GRAD_TOL, STEP_RTOL)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_at_the_port_init_matches_float64(case, batch, monkeypatch):
    """Both packages' steps in float64 from the same weights agree to
    ``F64_TOL``: no formula of the step differs between them."""
    cfg, state, hrnet_sd, shiftnet_sd = _step_inputs(case)
    want = _jax_step(cfg, hrnet_sd, shiftnet_sd, batch, monkeypatch, float64=True)
    monkeypatch.undo()
    port_float64(monkeypatch)
    state, m, thetas = _port_step(cfg, state_to_float64(state), batch, monkeypatch)
    _assert_step_matches(cfg, state, m, thetas, want, F64_TOL, F64_TOL)


@pytest.mark.parametrize("clip", [0.0, 1e-3, 10.0])
def test_optimizer_and_clip_match_optax(clip):
    """Three steps on identical gradients from zero parameters, with an lr
    change in between, as the plateau scheduler makes one."""
    rng = np.random.default_rng(int(clip * 1000))
    shapes = [(4, 3), (5,), (2, 2, 3)]
    grads = [[rng.standard_normal(s).astype(np.float32) * 0.01 for s in shapes] for _ in range(3)]
    lrs = [1e-3, 1e-3, 5e-4]

    params = [torch.nn.Parameter(torch.zeros(s)) for s in shapes]
    opt = port_make_optimizer(params, lrs[0])
    tx = jax_make_optimizer(lrs[0], clip)
    jparams = [jnp.zeros(s) for s in shapes]
    jstate = tx.init(jparams)
    for g, lr in zip(grads, lrs):
        for group in opt.param_groups:
            group["lr"] = lr
        jstate.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        for p, gi in zip(params, g):
            p.grad = torch.from_numpy(gi.copy())
        norm = global_norm([p.grad for p in params])
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(g)), rtol=1e-6)
        if clip > 0:
            clip_by_global_norm_([p.grad for p in params], clip, norm)
        opt.step()
        updates, jstate = tx.update([jnp.asarray(gi) for gi in g], jstate, jparams)
        jparams = [p + u for p, u in zip(jparams, updates)]
        for p, jp in zip(params, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-5, atol=1e-5 * lrs[0])


def test_plateau_matches_jax():
    from highresnet_tpu.train.schedule import ReduceLROnPlateau as JaxPlateau
    from highresnet_tpu_torch.train.schedule import ReduceLROnPlateau

    values = [10.0, 9.0, 9.5, 9.4, 9.3, 9.2, 8.0, 8.1, 8.2, 8.3, 8.4, 7.0]  # test_plateau_matches_torch
    values += (-40 + np.random.default_rng(0).normal(scale=0.5, size=24)).tolist()
    mine, ref = ReduceLROnPlateau(0.1, factor=0.5, patience=2), JaxPlateau(0.1, factor=0.5, patience=2)
    assert [mine.step(v) for v in values] == [ref.step(v) for v in values]
    assert mine.state_dict() == ref.state_dict()


def test_eval_step_matches_jax(train_root):
    from highresnet_tpu.train.step import build_eval_step as jax_build_eval_step

    cfg = _config()
    state = create_train_state(cfg, "cpu", torch.Generator().manual_seed(2))
    sets = [read_imageset(d, top_k=4, beta=0.0) for d in discover_scenes(f"{train_root}/train")[:2]]
    b = collate(sets, 4)
    args = (b.lrs, b.alphas, b.hrs, b.hr_maps)
    srs, scores = port_step.build_eval_step(state.hrnet)(
        state.params["hrnet"], *[torch.from_numpy(a) for a in args])
    params = hrnet_params_from_torch(state.hrnet.state_dict(), num_res_layers=1)
    want_srs, want_scores = jax_build_eval_step(JaxHRNet(config=cfg["network"]), cfg)(params, *args)
    assert srs.shape == (2, 72, 72)
    np.testing.assert_allclose(srs.numpy(), np.asarray(want_srs), rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), atol=1e-3)


def test_warp_window_guard_matches_jax():
    from highresnet_tpu.train.epoch import warn_warp_window as jax_warn
    from highresnet_tpu.train.epoch import warp_window_px as jax_window
    from highresnet_tpu_torch.train.epoch import warn_warp_window, warp_window_px

    for t in ({}, {"warp_int_range": 0}, {"warp_int_range": 4}):
        assert warp_window_px(t) == jax_window(t)
    t = {"register": True, "warp_int_range": 0}
    calls = [(2.0, 1, 1), (3.5, 1, 1), (5.0, 1, 2), (5.0, 2, 2), (2.0, 3, 4), (9.0, 50, 4)]
    with pytest.warns(UserWarning, match="warp"):
        got = [warn_warp_window(t, *c) for c in calls]
        want = [jax_warn(t, *c) for c in calls]
    assert got == want == [1, 2, 2, 4, 4, 100]


def test_ema_and_unknown_loss(batch):
    cfg = _config(ema_decay=0.5)
    state = _port_state(cfg)
    step = port_step.build_train_step(cfg)
    args = [torch.from_numpy(a) for a in (batch.lrs, batch.alphas, batch.hrs, batch.hr_maps)]
    expected = {k: p.detach().clone() for k, p in state.hrnet.named_parameters()}
    for _ in range(2):
        state, _ = step(state, *args)
        expected = {k: 0.5 * e + 0.5 * p.detach() for (k, p), e in
                    zip(state.hrnet.named_parameters(), expected.values())}
    for k, e in expected.items():
        torch.testing.assert_close(state.ema["hrnet"][k], e, rtol=1e-6, atol=1e-7)
    assert state.eval_params is state.ema
    with pytest.raises(ValueError, match="training.loss"):
        port_step.build_train_step(_config(loss="nonsense"))


@pytest.mark.parametrize("key, value", [
    ("mesh", {"data": 2}),
])
def test_options_outside_the_slice_raise(train_root, key, value):
    """A layout the run's processes cannot hold: one process, two replicas."""
    from highresnet_tpu_torch.train.loop import train_and_get_best_model

    with pytest.raises(ValueError, match="exceeds the 1 processes"):
        train_and_get_best_model(_config(train_root, **{key: value}), device="cpu")


def test_f1_bf16_compute_keeps_f32_params_and_grads(batch):
    cfg = _config(compute_dtype="bfloat16")
    state = _port_state(cfg)
    step = port_step.build_train_step(cfg)
    state, m = step(state, *[torch.from_numpy(a) for a in
                             (batch.lrs, batch.alphas, batch.hrs, batch.hr_maps)])
    assert np.isfinite(m["loss"].item())
    for model in (state.hrnet, state.shiftnet):
        for name, p in model.named_parameters():
            assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
    # Adam's moments are f32 too: the optimizer updates f32 master weights
    assert all(s["exp_avg"].dtype == torch.float32 for s in state.optimizer.state.values())
    seen = {}
    state.hrnet.encode.register_forward_hook(
        lambda mod, a, out: seen.__setitem__("encode", out.dtype))
    state.hrnet(torch.from_numpy(batch.lrs), torch.from_numpy(batch.alphas))
    assert seen["encode"] == torch.bfloat16


def test_config_tpu_bf16_takes_a_step_with_f32_params():
    """configs/config_tpu_bf16.json with its training keys as they are (bf16
    compute, ``data_parallel`` on one process, batch 32 of 32 views at 64 px,
    register 128) and the network narrowed to TINY_CONFIG's width: the step
    its first 30 epochs take (unregistered) and the registered one after;
    each loss finite, every parameter, gradient and Adam moment f32 (F1)."""
    from highresnet_tpu_torch.config import load_config
    from highresnet_tpu_torch.parallel.mesh import setup_data_parallel

    cfg = load_config(os.path.join(REPO, "configs", "config_tpu_bf16.json"))
    cfg["network"] = copy.deepcopy(TINY_CONFIG["network"])
    t = cfg["training"]
    assert t["compute_dtype"] == "bfloat16" and t["data_parallel"] is True
    layout = setup_data_parallel(t, torch.device("cpu"))
    assert layout.world == 1 and not layout.synced
    state = create_train_state(cfg, "cpu", torch.Generator().manual_seed(0))
    assert state.hrnet.dtype == torch.bfloat16 and state.shiftnet.dtype == torch.bfloat16
    rng = np.random.default_rng(0)
    b, l, p = t["batch_size"], t["min_L"], t["patch_size"]
    batch = [torch.from_numpy(a) for a in (
        rng.random((b, l, p, p), np.float32), np.ones((b, l), np.float32),
        rng.random((b, 3 * p, 3 * p), np.float32), np.ones((b, 3 * p, 3 * p), np.float32))]
    for register in (False, True):
        step_cfg = copy.deepcopy(cfg)
        step_cfg["training"]["register"] = register
        state, m = port_step.build_train_step(step_cfg, layout)(state, *batch)
        assert np.isfinite(m["loss"].item()), register
        # the registered loss reaches ShiftNet (its zero fc2 predicts no shift yet)
        assert bool(state.shiftnet.fc2.weight.grad.abs().max() > 0) == register
        for model in (state.hrnet, state.shiftnet):
            for name, prm in model.named_parameters():
                assert prm.dtype == torch.float32 and prm.grad.dtype == torch.float32, name
        assert all(s["exp_avg"].dtype == torch.float32 for s in state.optimizer.state.values())
    assert state.step == 2


# --- cli.train end to end ---------------------------------------------------


def _write_config(train_root, tmp_path, name, **training):
    cfg = _config(train_root, **training)
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.fixture(scope="module")
def cli_runs(train_root, tmp_path_factory):
    """1 epoch then a resume to 2 in one run dir; 2 epochs straight in another."""
    from highresnet_tpu_torch.cli.train import main as train_main

    tmp = tmp_path_factory.mktemp("cli")
    one = _write_config(train_root, tmp, "one", num_epochs=1)
    two = _write_config(train_root, tmp, "two", num_epochs=2)
    resumed, straight = str(tmp / "resumed"), str(tmp / "straight")
    first = train_main(["--config", one, "--run-dir", resumed, "--device", "cpu"])
    with open(os.path.join(resumed, "latest.json")) as f:
        after_one = json.load(f)
    train_main(["--config", two, "--run-dir", resumed, "--device", "cpu"])
    train_main(["--config", two, "--run-dir", straight, "--device", "cpu"])
    return {"resumed": resumed, "straight": straight, "after_one": after_one,
            "first": first, "config": two}


def _final_state(run_dir):
    with open(os.path.join(run_dir, "latest.json")) as f:
        latest = json.load(f)
    path = os.path.join(run_dir, latest["slot"], "state.pt")
    return latest, torch.load(path, map_location="cpu", weights_only=True)


def test_cli_train_resume_is_bit_identical(cli_runs):
    latest_a, a = _final_state(cli_runs["resumed"])
    latest_b, b = _final_state(cli_runs["straight"])
    assert cli_runs["after_one"]["epoch"] == 1 and latest_a["epoch"] == latest_b["epoch"] == 2
    assert latest_a["val_history"] == latest_b["val_history"]
    assert latest_a["scheduler"] == latest_b["scheduler"]
    assert a["step"] == b["step"] > 0
    for model in ("hrnet", "shiftnet"):
        assert a[model].keys() == b[model].keys()
        for k in a[model]:
            assert torch.equal(a[model][k], b[model][k]), (model, k)
    for sa, sb in zip(a["optimizer"]["state"].values(), b["optimizer"]["state"].values()):
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert torch.equal(a["generator"], b["generator"])


def test_cli_train_run_dir_serves_through_predict(cli_runs):
    from highresnet_tpu_torch.cli.predict import main as predict_main
    from highresnet_tpu_torch.models import HRNet, ShiftNet, load_weights

    run_dir = cli_runs["resumed"]
    latest, _ = _final_state(run_dir)
    assert os.path.isdir(os.path.join(run_dir, latest["slot"]))
    with open(os.path.join(run_dir, "best_score.json")) as f:
        best = json.load(f)
    assert np.isfinite(best["score"]) and best["score"] == latest["best_score"]
    net = TINY_CONFIG["network"]
    sd = load_weights(run_dir)  # a run dir: reads best/HRNet.pth
    HRNet(net).load_state_dict(sd)
    ShiftNet(register_size=32).load_state_dict(
        torch.load(os.path.join(run_dir, "best", "ShiftNet.pth"), weights_only=True))
    table = predict_main(["--config", cli_runs["config"], "--checkpoint", run_dir,
                          "--splits", "train", "val", "--device", "cpu"])
    assert len(table) == 4 and np.isfinite(table["model"].astype(float)).all()
    assert cli_runs["first"]["best_epoch"] == 1
