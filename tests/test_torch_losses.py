"""The port's losses against the JAX package: values and gradients of the
three criteria and the registered loss, the detached brightness bias, and
the border mask."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from highresnet_tpu.ops import losses as jax_losses
from highresnet_tpu_torch.ops import losses

RTOL = 1e-5


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    sr = rng.random((3, 12, 12), dtype=np.float32)
    hr = np.clip(sr + rng.normal(0.05, 0.02, sr.shape), 0, 1).astype(np.float32)
    mask = (rng.random(sr.shape) > 0.2).astype(np.float32) * losses.crop_mask(4, 1)
    shifts = rng.uniform(-1, 1, (3, 2)).astype(np.float32)
    return sr, hr, mask, shifts


@pytest.mark.parametrize("metric", ["cPSNR", "cMSE", "masked_MSE"])
def test_get_loss_matches_jax(metric):
    sr, hr, mask, _ = _inputs(0)
    want, vjp = jax.vjp(lambda s: jax_losses.get_loss(s, hr, mask, metric=metric), jnp.asarray(sr))
    g = np.random.default_rng(1).standard_normal(want.shape).astype(np.float32)
    (want_grad,) = vjp(jnp.asarray(g))
    ts = torch.from_numpy(sr).requires_grad_()
    got = losses.get_loss(ts, torch.from_numpy(hr), torch.from_numpy(mask), metric=metric)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL)
    scale = np.abs(np.asarray(want_grad)).max()
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(want_grad), rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize("metric", ["cPSNR", "cMSE", "masked_MSE"])
def test_registered_loss_matches_jax(metric):
    sr, hr, mask, shifts = _inputs(2)
    lam = 0.3  # large, so the regulariser shows

    def f(s, d):
        return jax_losses.registered_loss(s, hr, mask, d, lam, metric=metric)

    want, (want_gs, want_gd) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(sr), jnp.asarray(shifts)
    )
    ts = torch.from_numpy(sr).requires_grad_()
    td = torch.from_numpy(shifts).requires_grad_()
    got = losses.registered_loss(ts, torch.from_numpy(hr), torch.from_numpy(mask), td, lam,
                                 metric=metric)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    scale = np.abs(np.asarray(want_gs)).max()
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(want_gs), rtol=RTOL, atol=RTOL * scale)
    # lam * mean(d)^2, not mean(d^2): every component gets 2 lam mean(d) / n
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(want_gd), rtol=RTOL)
    np.testing.assert_allclose(td.grad.numpy(), 2 * lam * shifts.mean() / shifts.size, rtol=RTOL)


def test_cmse_bias_is_detached():
    """A uniform brightness offset of the SR changes nothing, and the
    gradient has no component along it."""
    sr, hr, mask, _ = _inputs(3)
    ts = torch.from_numpy(sr).requires_grad_()
    base = losses.cmse(ts, torch.from_numpy(hr), torch.from_numpy(mask))
    shifted = losses.cmse(ts.detach() + 0.1, torch.from_numpy(hr), torch.from_numpy(mask))
    np.testing.assert_allclose(shifted.numpy(), base.detach().numpy(), rtol=1e-4)
    base.sum().backward()
    want = jax.grad(lambda s: jax_losses.cmse(s, hr, mask).sum())(jnp.asarray(sr))
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(want), rtol=RTOL,
                               atol=RTOL * np.abs(np.asarray(want)).max())


def test_crop_mask_and_unknown_metric():
    for patch, crop in ((16, 1), (64, 3), (4, 0)):
        assert np.array_equal(losses.crop_mask(patch, crop), jax_losses.crop_mask(patch, crop))
    assert losses.LOSS_METRICS == jax_losses.LOSS_METRICS
    with pytest.raises(ValueError, match="unknown loss metric"):
        losses.get_loss(torch.zeros(1, 2, 2), torch.zeros(1, 2, 2), torch.ones(1, 2, 2), "L1")
