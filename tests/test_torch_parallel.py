"""The port's data parallelism on the CPU: two Gloo ranks against one process.

Each two-rank case starts two child processes (``tests/_torch_ranks.py``,
``file://`` store, 120 s each) that hold half of a global batch:

- the synced ``BatchNorm2d``: output, input/weight/bias gradients and the
  running statistics against one process with the whole batch (1e-6);
- the two-rank train step, dropout off, against the JAX single-device step
  on the config of tests/test_parallel.py::test_dp_train_step_matches_single_device
  (registration crop 32 px, see DP_CONFIG) from the same weights (loss rtol
  1e-5, parameters atol 2e-5, JAX's own tolerances there);
- the two-rank step with dropout on against the port's one-process step
  (same tolerances; one global mask draw, the generators end equal);
- the layout's checks (``ValueError`` as in JAX; ``training.mesh`` across
  processes, which JAX refuses, is the port's layout) and
  ``maybe_initialize``'s reading of the environment.
"""

import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_ranks as tr
import highresnet_tpu.train.step as jax_step
from highresnet_tpu.models import HRNet as JaxHRNet
from highresnet_tpu.models import ShiftNet as JaxShiftNet
from highresnet_tpu.models.convert import hrnet_params_from_torch, shiftnet_from_torch
from highresnet_tpu.train.state import TrainState as JaxTrainState
from highresnet_tpu.train.state import make_optimizer as jax_make_optimizer
from highresnet_tpu_torch.models.convert import (
    hrnet_state_dict_from_flax,
    shiftnet_state_dict_from_flax,
)
from highresnet_tpu_torch.parallel import distributed, mesh
from highresnet_tpu_torch.train.state import create_train_state
from highresnet_tpu_torch.train.step import build_train_step
from test_torch_train import jax_float64

BN_TOL = 1e-6
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-5
GRAD_TOL = 1e-4  # tests/test_torch_train.py: max |Δg| per tensor over its norm

# tests/test_parallel.py::test_dp_train_step_matches_single_device, its
# registration crop at 32 px (patch 16): at 24 px (patch 12) XLA:CPU's
# compiled ShiftNet backward moves the conv gradients of layers 1-6 by up to
# 8% of their norm from the same JAX function run op by op, which agrees
# with the port to 4e-7; at 32 px the compiled step agrees to 3e-5
DP_CONFIG = {
    "network": {
        "encoder": {"in_channels": 2, "num_layers": 1, "kernel_size": 3, "channel_size": 4},
        "recursive": {"alpha_residual": True, "in_channels": 4, "kernel_size": 3},
        "decoder": {
            "deconv": {"in_channels": 4, "kernel_size": 3, "stride": 3, "out_channels": 4},
            "final": {"in_channels": 4, "kernel_size": 1, "out_channels": 1},
        },
    },
    "training": {
        "batch_size": 8, "min_L": 2, "n_views": 2, "crop": 1, "lr": 1e-3,
        "lambda": 1e-6, "beta": 50.0, "patch_size": 16, "register_size": 32,
    },
}


def test_synced_batchnorm_matches_whole_batch(tmp_path):
    from highresnet_tpu_torch.models.layers import BatchNorm2d

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0.3, 2.0, (4, 3, 6, 5)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(4, 3, 6, 5)).astype(np.float32))
    bn = BatchNorm2d(3)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([0.5, 1.5, -2.0]))
        bn.bias.copy_(torch.tensor([0.1, -0.2, 0.3]))
        bn.running_mean.copy_(torch.tensor([0.2, 0.0, -0.1]))
        bn.running_var.copy_(torch.tensor([1.5, 0.7, 1.0]))
    state = {k: v.clone() for k, v in bn.state_dict().items()}

    xw = x.clone().requires_grad_(True)
    y = bn.train()(xw)
    (y * g).sum().backward()
    ranks = tr.launch("bn", {"x": x, "g": g, "state": state}, tmp_path)

    def close(got, want, what):
        torch.testing.assert_close(got, want, rtol=BN_TOL, atol=BN_TOL, msg=what)

    close(torch.cat([r["y"] for r in ranks]), y.detach(), "output")
    close(torch.cat([r["dx"] for r in ranks]), xw.grad, "input gradient")
    close(sum(r["dw"] for r in ranks), bn.weight.grad, "weight gradient")
    close(sum(r["db"] for r in ranks), bn.bias.grad, "bias gradient")
    for r in ranks:
        for k, v in bn.named_buffers():
            close(r["buffers"][k], v, k)


def _inputs(dropout: float) -> dict:
    """The seeded port state of DP_CONFIG with a random fc2 (nonzero shifts)
    and one global batch, as the ranks and the oracles take them."""
    state = create_train_state(DP_CONFIG, "cpu", torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    with torch.no_grad():
        state.shiftnet.fc2.weight.copy_(
            torch.from_numpy(rng.normal(0, 0.02, (2, 1024)).astype(np.float32)))
    b, l, p = 8, 2, 16
    batch = (
        rng.random((b, l, p, p)).astype(np.float32),
        np.ones((b, l), np.float32),
        rng.random((b, 3 * p, 3 * p)).astype(np.float32),
        np.ones((b, 3 * p, 3 * p), np.float32),
    )
    return {"config": DP_CONFIG, "hrnet": state.hrnet.state_dict(),
            "shiftnet": state.shiftnet.state_dict(), "dropout": dropout,
            "generator": state.generator.get_state(), "batch": batch}


def _to_port(params, batch_stats) -> dict:
    """JAX {'hrnet', 'shiftnet'} trees -> the port's flat state-dict names."""
    sd = {f"hrnet.{k}": v for k, v in hrnet_state_dict_from_flax(params["hrnet"]).items()}
    sd.update({f"shiftnet.{k}": v for k, v in shiftnet_state_dict_from_flax(
        params["shiftnet"], batch_stats).items()})
    return sd


def _jax_step(inp: dict, monkeypatch, capture: bool = False, jax_mesh=None):
    """The JAX step in float64 (``test_torch_train.jax_float64``: at the
    port's init JAX's own f32 rounding of some gradients leaves the exact
    step by more than the limits below) on ``inp``'s config (dropout the
    identity) from the port's weights, on one device or, with ``jax_mesh``,
    on JAX's 2-D data x view layout (tests/test_parallel.py's specs): real
    Adam, or with ``capture`` an optimizer whose state becomes the gradient.
    Returns (loss, post-step params or gradients, port names)."""
    from jax.sharding import PartitionSpec as P

    from highresnet_tpu.parallel.mesh import put_with_specs

    config = inp["config"]
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    tx = jax_make_optimizer(config["training"]["lr"])
    if capture:
        tx = optax.GradientTransformation(
            lambda p: jax.tree.map(jnp.zeros_like, p),
            lambda u, s, p=None: (jax.tree.map(jnp.zeros_like, u), u),
        )
        monkeypatch.setattr(jax_step, "make_optimizer", lambda *a, **k: tx)
    wide = lambda sd: {k: v.double() if v.is_floating_point() else v for k, v in sd.items()}
    sn_params, stats = shiftnet_from_torch(wide(inp["shiftnet"]))
    params = {"hrnet": hrnet_params_from_torch(wide(inp["hrnet"]), num_res_layers=1),
              "shiftnet": sn_params}
    with jax_float64(monkeypatch):
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                              opt_state=tx.init(params), rng=jax.random.PRNGKey(0))
        step = jax_step.build_train_step(
            JaxHRNet(config=config["network"], dtype=jnp.float64),
            JaxShiftNet(dtype=jnp.float64), config, mesh=jax_mesh,
            shard_views=jax_mesh is not None)
        batch = tuple(np.asarray(a, np.float64) for a in inp["batch"])
        if jax_mesh is not None:
            batch = put_with_specs(jax_mesh, batch, (P("data", "view", None, None),
                                                     P("data", "view"), P("data", None, None),
                                                     P("data", None, None)))
        new, metrics = step(state, *batch)
        new, metrics = jax.device_get((new, metrics))
    monkeypatch.undo()
    tree = new.opt_state if capture else new.params
    return float(metrics["loss"]), _to_port(tree, new.batch_stats)


# gradients that are zero in exact arithmetic (conv biases that feed a
# BatchNorm; the SR's output bias under cPSNR, which a uniform offset leaves
# unchanged): both sides hold rounding noise, and Adam's first update,
# lr·g/(|g| + eps), turns that noise into ±lr
def _noise_gradient(name: str) -> bool:
    return ((name.startswith("shiftnet.layer") and name.endswith(".0.bias"))
            or name == "hrnet.decode.final.bias")


def _assert_step_close(r: dict, loss: float, params: dict, grads: dict) -> float:
    """One rank's step against an oracle's loss, post-step parameters and
    gradients (port names). Loss rtol 1e-5. Each gradient within 1e-4 of its
    tensor's norm (of the global norm where the exact gradient is zero).
    Parameters after Adam within 2e-5 wherever the gradient's sign is sure:
    Adam's first step is nearly lr·sign(g), so an element whose gradient is
    under ten times its tensor's measured disagreement, and every element
    of a zero-in-exact-arithmetic tensor, may step either way; their
    gradients are held above. Returns the share of parameters held."""
    np.testing.assert_allclose(r["metrics"]["loss"], loss, rtol=LOSS_RTOL)
    norm = r["metrics"]["grad_norm"]
    held = []
    for k, g in grads.items():
        g = g.numpy()
        diff = np.abs(r["grads"][k].numpy() - g)
        agree = GRAD_TOL * (norm if _noise_gradient(k) else np.linalg.norm(g))
        assert diff.max() <= agree, (k, diff.max(), agree)
        if _noise_gradient(k):
            continue
        sure = (np.abs(g) > 10 * diff.max()) | (g == 0)
        np.testing.assert_allclose(r["params"][k].numpy()[sure], params[k].numpy()[sure],
                                   atol=PARAM_ATOL, err_msg=k)
        held.append(sure.ravel())
    for k, v in params.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(r["params"][k].numpy(), v.numpy(), rtol=LOSS_RTOL,
                                       atol=LOSS_RTOL * np.abs(v.numpy()).max(), err_msg=k)
    return float(np.concatenate(held).mean())


def test_two_rank_step_matches_jax_step(tmp_path, monkeypatch):
    inp = _inputs(dropout=0.0)
    ranks = tr.launch("step", inp, tmp_path)
    want_loss, want = _jax_step(inp, monkeypatch)
    _, want_grads = _jax_step(inp, monkeypatch, capture=True)
    grads = {k: v for k, v in want_grads.items() if k.split(".")[-1] in ("weight", "bias")}
    for r in ranks:
        assert _assert_step_close(r, want_loss, want, grads) > 0.99
    _assert_ranks_equal(ranks)


def _assert_ranks_equal(ranks) -> None:
    a, *rest = ranks
    for b in rest:
        assert a["metrics"] == b["metrics"]
        for k in a["params"]:
            assert torch.equal(a["params"][k], b["params"][k]), k
        assert torch.equal(a["generator"], b["generator"])


def test_two_rank_step_with_dropout_matches_one_process(tmp_path):
    inp = _inputs(dropout=0.5)
    ranks = tr.launch("step", inp, tmp_path)
    state = tr.port_state(inp)
    state, metrics = build_train_step(DP_CONFIG)(
        state, *[torch.from_numpy(a) for a in inp["batch"]])
    want = tr.step_result(state, metrics)
    for r in ranks:
        assert _assert_step_close(r, want["metrics"]["loss"], want["params"], want["grads"]) > 0.99
        for k in ("mean_abs_shift", "max_abs_shift", "grad_norm"):
            np.testing.assert_allclose(r["metrics"][k], want["metrics"][k], rtol=LOSS_RTOL,
                                       err_msg=k)
        assert torch.equal(r["generator"], want["generator"])  # one draw of the global shape
    assert want["metrics"]["max_abs_shift"] > 0.0
    _assert_ranks_equal(ranks)


# --- the layout and the environment --------------------------------------------


class _Group:
    """A stand-in process group of ``world`` ranks for the layout checks."""

    def __init__(self, monkeypatch, world: int, rank: int = 0):
        monkeypatch.setattr(mesh, "process_count", lambda: world)
        monkeypatch.setattr(mesh, "process_index", lambda: rank)
        monkeypatch.setattr(mesh, "is_initialized", lambda: True)


def _t(**training):
    t = copy.deepcopy(DP_CONFIG["training"])
    t.update(training)
    return t


def test_layout_refusals(monkeypatch):
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match=r"data\*view = 2\*1 exceeds the 1 processes"):
        mesh.setup_data_parallel(_t(mesh={"data": 2}), cpu)  # one process
    _Group(monkeypatch, world=3)
    # JAX refuses training.mesh across hosts ("a single-controller feature");
    # every multi-card run of the port is multi-process, so it takes the layout
    meshed = mesh.setup_data_parallel(_t(batch_size=6, mesh={"data": 3}), cpu)
    assert meshed == mesh.DataParallel(rank=0, world=3, synced=True, local_batch=2, view=1,
                                       meshed=True)
    with pytest.raises(ValueError, match=r"data\*view = 1\*2 leaves ranks of the 3 processes"):
        mesh.setup_data_parallel(_t(mesh={"data": 1, "view": 2}), cpu)
    with pytest.raises(ValueError, match=r"divisible by the global device count \(8 % 3\)"):
        mesh.setup_data_parallel(_t(), cpu)
    layout = mesh.setup_data_parallel(_t(batch_size=6), cpu)
    assert layout == mesh.DataParallel(rank=0, world=3, synced=True, local_batch=2)
    assert layout.drop_last and layout.eval_batch(1) == 1 and layout.eval_batch(4) == 6
    with pytest.raises(ValueError, match="batch_size 2 exceeds the 1 local training scenes"):
        mesh.check_local_shard(layout, 1)
    mesh.check_local_shard(layout, 2)


def test_data_parallel_in_one_process_says_how_to_launch(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    layout = mesh.setup_data_parallel(_t(), torch.device("cuda", 0))
    assert layout == mesh.DataParallel(rank=0, world=1, synced=False, local_batch=8)
    out = capsys.readouterr().out
    assert "torchrun --nproc-per-node 4" in out and "HRN_DISTRIBUTED=auto" in out
    mesh.setup_data_parallel(_t(data_parallel=False), torch.device("cuda", 0))
    mesh.setup_data_parallel(_t(), torch.device("cpu"))
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("env, device, backend, want", [
    ({}, "cpu", None, None),
    ({"HRN_COORDINATOR": "localhost:1234", "HRN_NUM_PROCESSES": "2", "HRN_PROCESS_ID": "1"},
     "cpu", None, {"backend": "gloo", "init_method": "tcp://localhost:1234", "world_size": 2,
                   "rank": 1}),
    ({"HRN_DISTRIBUTED": "auto"}, "cuda:1", None, {"backend": "nccl", "init_method": "env://"}),
    ({"HRN_DISTRIBUTED": "auto"}, "cuda:0", "gloo", {"backend": "gloo", "init_method": "env://"}),
])
def test_maybe_initialize_reads_the_environment(monkeypatch, env, device, backend, want):
    for k in ("HRN_COORDINATOR", "HRN_DISTRIBUTED", "HRN_NUM_PROCESSES", "HRN_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls, devices = [], []
    monkeypatch.setattr(distributed.dist, "init_process_group", lambda **kw: calls.append(kw))
    monkeypatch.setattr(torch.cuda, "set_device", devices.append)
    distributed.maybe_initialize(device, backend=backend)
    if want is None:
        assert calls == []
        return
    (kw,) = calls
    assert kw.pop("timeout") == distributed.TIMEOUT
    assert kw == want
    assert devices == ([torch.device(device)] if want["backend"] == "nccl" else [])


def test_bare_cuda_follows_local_rank(monkeypatch):
    from highresnet_tpu_torch.runtime import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert resolve_device("cuda") == torch.device("cuda", 1)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="only 2 CUDA device"):
        resolve_device("cuda")
