"""The port's ShiftNet against the JAX ShiftNet on the same weights: eval-mode
outputs, BatchNorm running statistics after train-mode forwards (dropout
off on both sides: the frameworks' masks cannot agree), the parameter
count, the weight bridge both ways, and registration plus warp."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from highresnet_tpu.models.convert import shiftnet_from_torch
from highresnet_tpu.models.shiftnet import ShiftNet as JaxShiftNet
from highresnet_tpu.models.shiftnet import apply_shifts as jax_apply_shifts
from highresnet_tpu.models.shiftnet import register_views as jax_register_views
from highresnet_tpu_torch.models import (
    ShiftNet,
    apply_shifts,
    param_count,
    register_views,
    shiftnet_state_dict_from_flax,
)

RS = 32  # register size: fc1 is 2048 -> 1024


def _port_model(seed: int = 0) -> ShiftNet:
    """Random fc2 (it starts at zero) and BN statistics away from (0, 1),
    so every layer shows in the output."""
    model = ShiftNet(register_size=RS, generator=torch.Generator().manual_seed(seed))
    model.dropout = 0.0
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        model.fc2.weight.copy_(torch.from_numpy(rng.normal(0, 0.05, (2, 1024)).astype(np.float32)))
        for i in range(1, 9):
            bn = getattr(model, f"layer{i}")[1]
            bn.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.1, bn.num_features)))
            bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, bn.num_features)))
    return model


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_param_count_at_register_128_on_meta():
    model = ShiftNet(register_size=128, device="meta")
    assert all(p.is_meta for p in model.parameters())
    assert param_count(model) == 34_187_648


def test_shiftnet_eval_matches_jax():
    model = _port_model(1).eval()
    params, stats = shiftnet_from_torch(model.state_dict())
    x = np.random.default_rng(2).random((3, RS, RS, 2), dtype=np.float32)
    want = np.asarray(JaxShiftNet().apply({"params": params, "batch_stats": stats},
                                          jnp.asarray(x), train=False))
    with torch.no_grad():
        got = model(_nchw(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (3, 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_bn_running_stats_after_three_train_forwards(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    model = _port_model(3).train()
    params, stats = shiftnet_from_torch(model.state_dict())
    variables = {"params": params, "batch_stats": stats}
    rng = np.random.default_rng(3)
    for step in range(3):
        x = rng.random((4, RS, RS, 2), dtype=np.float32)
        with torch.no_grad():
            got = model(_nchw(x)).numpy()
        want, mutated = JaxShiftNet().apply(
            variables, jnp.asarray(x), train=True, rngs={"dropout": jax.random.PRNGKey(step)},
            mutable=["batch_stats"],
        )
        variables = {"params": params, "batch_stats": mutated["batch_stats"]}
        # batch statistics over 4 pairs amplify f32 rounding: outputs to 1e-5
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)
    _, got_stats = shiftnet_from_torch(model.state_dict())
    for i in range(1, 9):
        for s in ("mean", "var"):
            np.testing.assert_allclose(
                got_stats[f"bn{i}"][s], np.asarray(variables["batch_stats"][f"bn{i}"][s]),
                rtol=1e-5, atol=1e-6, err_msg=f"bn{i} {s}",
            )


def test_state_dict_round_trip_both_ways():
    model = _port_model(4)
    sd = model.state_dict()
    params, stats = shiftnet_from_torch(sd)
    back = shiftnet_state_dict_from_flax(params, stats)
    assert back.keys() == sd.keys()
    for k in sd:
        if not k.endswith("num_batches_tracked"):  # the JAX tree keeps no batch count
            assert torch.equal(back[k], sd[k]), k
    # a JAX-initialised ShiftNet loads strictly into the port and converts back
    variables = JaxShiftNet().init(jax.random.PRNGKey(0), jnp.zeros((1, RS, RS, 2)), train=False)
    jp = jax.tree_util.tree_map(np.asarray, variables["params"])
    js = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    fresh = ShiftNet(register_size=RS)
    fresh.load_state_dict(shiftnet_state_dict_from_flax(jp, js))
    p2, s2 = shiftnet_from_torch(fresh.state_dict())
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path({"p": jp, "s": js}),
                                 jax.tree_util.tree_leaves_with_path({"p": p2, "s": s2})):
        assert np.array_equal(a, b), path


def test_register_views_and_apply_shifts_match_jax():
    model = _port_model(5).eval()
    params, stats = shiftnet_from_torch(model.state_dict())
    rng = np.random.default_rng(5)
    views = rng.random((2, 3, RS, RS), dtype=np.float32)
    ref = rng.random((2, RS, RS), dtype=np.float32)
    want, _ = jax_register_views(JaxShiftNet(), {"params": params, "batch_stats": stats},
                                 jnp.asarray(views), jnp.asarray(ref))
    with torch.no_grad():
        got = register_views(model, torch.from_numpy(views), torch.from_numpy(ref))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)

    thetas = rng.uniform(-2, 2, (2, 3, 2)).astype(np.float32)
    want_w = np.asarray(jax_apply_shifts(jnp.asarray(views), jnp.asarray(thetas)))
    got_w = apply_shifts(torch.from_numpy(views), torch.from_numpy(thetas)).numpy()
    np.testing.assert_allclose(got_w, want_w, rtol=1e-5, atol=1e-6)


def test_dropout_draws_from_the_given_generator():
    model = ShiftNet(register_size=RS, generator=torch.Generator().manual_seed(6)).train()
    with torch.no_grad():
        model.fc2.weight.normal_(0, 0.05, generator=torch.Generator().manual_seed(0))
    x = torch.rand(2, 2, RS, RS, generator=torch.Generator().manual_seed(1))
    run = lambda seed: model(x, torch.Generator().manual_seed(seed)).detach()  # noqa: E731
    assert torch.equal(run(7), run(7))
    assert not torch.equal(run(7), run(8))
    with pytest.raises(ValueError, match="generator"):
        model(x)
    model.eval()
    assert torch.equal(model(x).detach(), model(x, torch.Generator()).detach())
