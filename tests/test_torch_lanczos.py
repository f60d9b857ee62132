"""The port's Lanczos warp against the JAX package: taps, the plain warp at
int_range 0 and 4, the Pallas kernel in interpret mode, and gradients for
image and shift through ``jax.vjp``; plus the fused warp's dispatch and its
autograd Function on the CPU.

The CUDA kernel (K3) runs only on a card: its test is in
``test_torch_cuda.py`` (``python3 chip_smoke.py`` checks it end to end).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from highresnet_tpu.ops.lanczos import lanczos_kernel as jax_lanczos_kernel
from highresnet_tpu.ops.lanczos import lanczos_shift as jax_lanczos_shift
from highresnet_tpu.ops.lanczos_pallas import lanczos_shift_pallas
from highresnet_tpu_torch.ops import lanczos, lanczos_fused

RTOL, ATOL = 1e-5, 1e-6  # f32 sums in another order than XLA's


def _inputs(seed: int, max_shift: float, shape=(3, 20, 17)):
    rng = np.random.default_rng(seed)
    img = rng.random(shape, dtype=np.float32)
    shift = rng.uniform(-max_shift, max_shift, (shape[0], 2)).astype(np.float32)
    shift[0] = [0.0, 1.0]  # the sinc guard and an integer tap position
    return img, shift


def test_lanczos_kernel_matches_jax():
    dx = np.array([0.0, 0.25, -0.5, 1.0, 2.7, -3.0], np.float32)
    want = np.asarray(jax_lanczos_kernel(jnp.asarray(dx)))
    got = lanczos.lanczos_kernel(torch.from_numpy(dx)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-6)


def test_reflect_pad_matches_numpy():
    x = np.random.default_rng(0).random((2, 5, 7), dtype=np.float32)
    for p in (1, 3, 4):
        want = np.pad(x, ((0, 0), (p, p), (p, p)), mode="reflect")
        assert np.array_equal(lanczos.reflect_pad(torch.from_numpy(x), p).numpy(), want)
    with pytest.raises(ValueError, match="reflect pad"):
        lanczos.reflect_pad(torch.from_numpy(x), 5)


@pytest.mark.parametrize("int_range", [0, 4])
def test_lanczos_shift_and_grads_match_jax(int_range):
    img, shift = _inputs(int_range, max_shift=5.0 if int_range else 3.0)
    g = np.random.default_rng(9).standard_normal(img.shape).astype(np.float32)

    def f(i, s):
        return jax_lanczos_shift(i, s, int_range=int_range)

    want, vjp = jax.vjp(f, jnp.asarray(img), jnp.asarray(shift))
    want_gi, want_gs = vjp(jnp.asarray(g))

    ti = torch.from_numpy(img).requires_grad_()
    ts = torch.from_numpy(shift).requires_grad_()
    got = lanczos.lanczos_shift(ti, ts, int_range=int_range)
    got.backward(torch.from_numpy(g))

    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(want_gi), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(want_gs), rtol=RTOL, atol=1e-5)


def test_plain_warp_matches_pallas_interpret():
    img, shift = _inputs(1, max_shift=3.0, shape=(2, 12, 9))
    want = np.asarray(lanczos_shift_pallas(jnp.asarray(img), jnp.asarray(shift), interpret=True))
    got = lanczos_fused.lanczos_shift_ref(torch.from_numpy(img), torch.from_numpy(shift))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_fused_warp_on_cpu_is_the_plain_version():
    img, shift = _inputs(2, max_shift=3.0, shape=(2, 8, 6))
    before = lanczos_fused.LAUNCHES
    ti = torch.from_numpy(img).requires_grad_()
    ts = torch.from_numpy(shift).requires_grad_()
    got = lanczos_fused.lanczos_shift_fused(ti, ts)
    assert torch.equal(got, lanczos_fused.lanczos_shift_ref(ti, ts))
    assert lanczos_fused.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        lanczos_fused.lanczos_shift_cuda(ti.detach(), torch.zeros(2, 7), torch.zeros(2, 7))

    # the autograd Function's backward is the plain version's VJP
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(img.shape).astype(np.float32))
    got.backward(g)
    want_gi, want_gs = ti.grad.clone(), ts.grad.clone()
    ti.grad = ts.grad = None
    lanczos_fused.LanczosShift.apply(ti, ts).backward(g)
    assert torch.equal(ti.grad, want_gi) and torch.equal(ts.grad, want_gs)

    dbl = (torch.from_numpy(img).double().requires_grad_(),
           torch.from_numpy(shift).double().requires_grad_())
    assert torch.autograd.gradcheck(lanczos_fused.LanczosShift.apply, dbl)
