"""The port's Lanczos warp against the JAX package: taps, the plain warp at
int_range 0 and 4, the Pallas kernel in interpret mode, and gradients for
image and shift through ``jax.vjp``; plus the fused warp's dispatch and its
autograd Function on the CPU, the kernel wrapper's argument checks, and a
NumPy copy of the tap arithmetic inside the kernel.

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
        lanczos_fused.lanczos_shift_cuda(ti.detach(), ts.detach())

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


@pytest.mark.parametrize("int_range, fused", [(0, False), (0, True), (4, False), (4, True)])
def test_training_warp_takes_the_train_steps_route(int_range, fused, monkeypatch):
    """The one choice the train step and the warm-start share: the fused warp
    only at int_range 0 with use_pallas_warp, the plain warp otherwise; each
    route equal to JAX's lanczos_shift at that int_range."""
    img, shift = _inputs(4, max_shift=5.0 if int_range else 3.0)
    routed = []
    real = lanczos_fused.lanczos_shift_fused
    monkeypatch.setattr(lanczos_fused, "lanczos_shift_fused",
                        lambda i, s: routed.append(True) or real(i, s))
    got = lanczos_fused.training_warp(torch.from_numpy(img), torch.from_numpy(shift), int_range,
                                      fused)
    assert routed == ([True] if fused and not int_range else [])
    want = np.asarray(jax_lanczos_shift(jnp.asarray(img), jnp.asarray(shift), int_range=int_range))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("img_shape, shift_shape, match", [
    ((2, 8, 6), (2, 2), "CUDA"),
    ((2, 8, 6), (2, 3), r"shift must be \(2, 2\)"),
    ((2, 8, 6), (3, 2), r"shift must be \(2, 2\)"),
    ((2, 8, 6), (2,), r"shift must be \(2, 2\)"),
    ((2, 8, 6), (2, 2, 1), r"shift must be \(2, 2\)"),
    ((8, 6), (2, 2), r"\(B, H, W\)"),
])
def test_lanczos_shift_cuda_checks_arguments(img_shape, shift_shape, match):
    """K3's wrapper takes (img (B, H, W), shift (B, 2)) on the card; on CPU
    tensors, or with a shift of another shape, it raises before any build."""
    before = lanczos_fused.LAUNCHES
    with pytest.raises(ValueError, match=match):
        lanczos_fused.lanczos_shift_cuda(torch.zeros(img_shape), torch.zeros(shift_shape))
    assert lanczos_fused.LAUNCHES == before


def kernel_taps_np(d: np.ndarray) -> np.ndarray:
    """csrc/lanczos_shift.cu's tap arithmetic in float32, in the kernel's
    order: (N,) offsets -> (N, 7) normalised taps."""
    d = np.asarray(d, np.float32)
    raw = []
    for t in range(7):
        pi_x = np.float32(3.14159265) * (np.float32(t - 3) - d)
        pi_x = np.where(pi_x == 0, np.float32(1e-6), pi_x).astype(np.float32)
        pi_x3 = pi_x / np.float32(3.0)
        raw.append((np.sin(pi_x) / pi_x) * (np.sin(pi_x3) / pi_x3))
    total = raw[0]
    for r in raw[1:]:
        total = total + r  # summed in order, t = 0..6
    out = np.stack([r / total for r in raw], axis=-1)
    assert out.dtype == np.float32
    return out


def test_in_kernel_taps_match_jax_lanczos_kernel():
    """The CPU oracle for the taps K3 computes: within 1e-6 of the JAX
    package's lanczos_kernel at shifts in ±3, exact integers included (the
    1e-6 guard at the sinc singularity)."""
    rng = np.random.default_rng(4)
    d = np.concatenate([
        np.arange(-3, 4, dtype=np.float32),  # integers: one tap hits pi_x == 0
        np.array([0.5, -0.5, 2.5, -2.5, 1e-7, -1e-7, 2.9999998, -2.9999998], np.float32),
        rng.uniform(-3, 3, 64).astype(np.float32),
    ])
    got = kernel_taps_np(d)
    want = np.asarray(jax_lanczos_kernel(jnp.asarray(d)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=0, atol=1e-6)
    # at an integer shift the taps are the unit impulse at that offset
    np.testing.assert_allclose(got[3], np.eye(7, dtype=np.float32)[3], atol=1e-6)
    # and the port's plain lanczos_kernel, the warp's CPU route, agrees too
    port = lanczos.lanczos_kernel(torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(got, port, rtol=0, atol=1e-6)
