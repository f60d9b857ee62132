"""The registration toolkit's warps, masked metrics and shift searches: the
port (highresnet_tpu_torch) against the JAX package on the same seeded
numpy inputs, on the CPU.

Tolerances: warps and the Lanczos downscale atol 1e-6 (float32 taps, XLA
may contract to FMAs); metrics rtol 1e-5; MI's joint histogram count for
count; the search grid within one float32 ulp of its magnitude (XLA
compiles JAX's linspace as start·(1 − i·r) + i·(stop·r) with FMAs per
vector lane, so no fixed float32 formula reproduces it bit for bit); final
search shifts within 0.01 px (fine levels' scores differ by less than
float32 rounding, so the argmax may pick a neighbour there).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter, shift as ndi_shift

from highresnet_tpu.ops.lanczos import lanczos_resample_2d as jax_resample
from highresnet_tpu.registration import metrics as jm
from highresnet_tpu.registration import search as js
from highresnet_tpu.registration import warp as jw
from highresnet_tpu_torch.ops.lanczos import lanczos_resample_2d
from highresnet_tpu_torch.registration import metrics as tm
from highresnet_tpu_torch.registration import search as ts
from highresnet_tpu_torch.registration import warp as tw

WARP_ATOL = 1e-6
METRIC_RTOL = 1e-5
SHIFT_PX = 0.01
TRUE_SHIFT = (0.7, -0.4)
METRICS = ("masked_ncc", "masked_mse", "masked_ml1e", "masked_ssim", "masked_mi")


@pytest.fixture(scope="module")
def pair():
    """A smooth 48 px field, its template shifted by TRUE_SHIFT (scipy, order
    3), a 3 px border mask and a cloud blob masked out of the reference."""
    rng = np.random.default_rng(0)
    ref = gaussian_filter(np.kron(rng.random((12, 12)), np.ones((4, 4))), 2.0).astype(np.float32)
    template = ndi_shift(ref, TRUE_SHIFT, mode="constant", order=3).astype(np.float32)
    border = np.zeros_like(ref)
    border[3:-3, 3:-3] = 1
    yy, xx = np.mgrid[:48, :48]
    ref_mask = border * (((yy - 15) ** 2 + (xx - 30) ** 2) > 36)
    return ref, template, ref_mask.astype(np.float32), border


def candidates(pair, n=9, seed=1):
    """n warped templates and masks (from JAX's warp) to score."""
    _, template, _, mask = pair
    shifts = np.random.default_rng(seed).uniform(-1.5, 1.5, (n, 2)).astype(np.float32)
    warped, wmasks = jw.shift_template_batch(jnp.asarray(template), jnp.asarray(mask),
                                             jnp.asarray(shifts))
    return np.asarray(warped), np.asarray(wmasks)


@pytest.mark.parametrize("size, scale", [(48, 3), (47, 3), (40, 2), (52, 4)])
def test_lanczos_resample_2d_matches_jax(size, scale):
    img = np.random.default_rng(size).random((size, size), dtype=np.float32)
    want = np.asarray(jax_resample(jnp.asarray(img), scale))
    got = lanczos_resample_2d(torch.from_numpy(img), scale).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=WARP_ATOL)


SHIFTS = np.array([[2.0, -3.0], [0.6, -1.3], [-0.25, 0.75], [0.0, 0.0],
                   [60.2, -0.5], [-0.3, -100.7], [1.5, 49.0]], np.float32)


@pytest.mark.parametrize("name", ["cubic_shift_batch", "linear_shift_batch"])
def test_warps_match_jax(pair, name):
    """Integer, sub-pixel and beyond-frame shifts, one per image."""
    imgs = np.stack([pair[0]] * len(SHIFTS))
    want = np.asarray(getattr(jw, name)(imgs, SHIFTS))
    got = getattr(tw, name)(imgs, SHIFTS, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=WARP_ATOL)


def test_shift_template_batch_and_apply_shift_match_jax(pair):
    _, template, _, mask = pair
    warped, wmasks = tw.shift_template_batch(template, mask, SHIFTS, device="cpu")
    jwarped, jwmasks = jw.shift_template_batch(jnp.asarray(template), jnp.asarray(mask),
                                               jnp.asarray(SHIFTS))
    np.testing.assert_allclose(warped.numpy(), np.asarray(jwarped), rtol=0, atol=WARP_ATOL)
    np.testing.assert_array_equal(wmasks.numpy(), np.asarray(jwmasks))
    # the (x, y) argument order
    img, msk = ts.apply_shift_to_template(-1.3, 0.6, template, mask, device="cpu")
    jimg, jmsk = js.apply_shift_to_template(-1.3, 0.6, template, mask)
    np.testing.assert_allclose(img.numpy(), jimg, rtol=0, atol=WARP_ATOL)
    np.testing.assert_allclose(msk.numpy(), jmsk, rtol=0, atol=WARP_ATOL)


@pytest.mark.parametrize("name, kwargs", [
    ("masked_ncc", {}),
    ("masked_mse", {}),
    ("masked_mse", {"normalize": False}),
    ("masked_ml1e", {}),
    ("masked_ml1e", {"use_masks": False}),
    ("masked_ssim", {}),
    ("masked_ssim", {"use_masks": False}),
    ("masked_mi", {}),
    ("masked_mi", {"bins": 32}),
])
def test_masked_metrics_match_jax_batched_and_single(pair, name, kwargs):
    """One call over N candidates equals JAX's vmap; each single pair equals
    JAX's single call."""
    ref, _, ref_mask, _ = pair
    warped, wmasks = candidates(pair)
    jax_fn, port_fn = getattr(jm, name), getattr(tm, name)
    want = np.asarray(jax.vmap(lambda w, m: jax_fn(ref, w, ref_mask, m, **kwargs))(warped, wmasks))
    got = port_fn(ref, warped, ref_mask, wmasks, device="cpu", **kwargs)
    assert got.shape == (len(warped),)
    np.testing.assert_allclose(got.numpy(), want, rtol=METRIC_RTOL)
    for i in (0, len(warped) - 1):
        single = port_fn(ref, warped[i], ref_mask, wmasks[i], device="cpu", **kwargs)
        assert single.shape == ()
        assert float(single) == pytest.approx(float(jax_fn(ref, warped[i], ref_mask, wmasks[i],
                                                           **kwargs)), rel=METRIC_RTOL)


def _jax_joint_counts(ref, mov, ref_mask, mov_mask, bins=100):
    """The first half of JAX's masked_mi (its bucketing), counted in numpy."""
    m = jm._combined_mask(ref_mask, mov_mask)

    def bucketize(x):
        lo, hi = jnp.min(x), jnp.max(x)
        t = (x - lo) / jnp.maximum(hi - lo, jm._EPS)
        return jnp.clip((t * bins).astype(jnp.int32), 0, bins - 1)

    idx = bucketize(ref * m).ravel() * bins + bucketize(mov * m).ravel()
    return np.bincount(np.asarray(idx), minlength=bins * bins).reshape(bins, bins)


def test_mi_joint_histogram_counts_exactly(pair):
    ref, _, ref_mask, _ = pair
    warped, wmasks = candidates(pair, n=4)
    got = tm.joint_counts(ref, warped, ref_mask, wmasks, device="cpu").numpy()
    for i in range(len(warped)):
        np.testing.assert_array_equal(got[i], _jax_joint_counts(ref, warped[i], ref_mask, wmasks[i]))
    assert got.sum(axis=(1, 2)).tolist() == [ref.size] * len(warped)


def test_masked_ncc_nan_contract(pair):
    """NaN for an empty mask or an image constant under it, per candidate."""
    ref, template, ref_mask, _ = pair
    movs = np.stack([template, np.full_like(template, 0.5), template])
    masks = np.stack([ref_mask, ref_mask, np.zeros_like(ref_mask)])
    got = tm.masked_ncc(ref, movs, ref_mask, masks, device="cpu").numpy()
    assert np.isfinite(got[0]) and np.isnan(got[1]) and np.isnan(got[2])
    for i in (1, 2):
        assert np.isnan(float(jm.masked_ncc(ref, movs[i], ref_mask, masks[i])))


@pytest.mark.parametrize("points_per_dim", [3, 4, 5, 7])
def test_grid_matches_jax(points_per_dim):
    """Every level's grid of the searches' sweep, against JAX's ``_grid``."""
    for minus in (1, 2):
        sf = js._scale_factor(points_per_dim, minus)
        assert ts._scale_factor(points_per_dim, minus) == sf
        for level in range(10):
            width = 2.0 * sf**level
            for center in ((0.0, 0.0), (0.3, -0.7), (-1.2, 0.45), (0.123, 1.9)):
                cj = jnp.asarray(center, jnp.float32)
                want = np.asarray(js._grid((cj[0] - width / 2, cj[0] + width / 2),
                                           (cj[1] - width / 2, cj[1] + width / 2),
                                           points_per_dim))
                got = ts._level_grid(torch.tensor(center), width, points_per_dim).numpy()
                assert got.shape == want.shape == (points_per_dim**2, 2)
                ulp = np.spacing(np.float32(np.abs(want).max()))
                assert np.abs(got - want).max() <= ulp, (points_per_dim, level, center)
                assert np.array_equal(got[[0, -1]], want[[0, -1]])  # the bounds exactly


@pytest.mark.parametrize("center, width", [((0.1, -0.2), 0.5), ((-0.7, 0.4), 2.0), ((0.0, 60.0), 2.0)])
def test_mncc_level_scores_match_jax(pair, center, width):
    """One level's score vector at a fixed centre; -inf where every candidate
    moves the template mask out of the frame."""
    ref, template, ref_mask, mask = pair
    jshifts, jscores = js._mncc_grid_scores(
        jnp.asarray(ref), jnp.asarray(ref_mask), jnp.asarray(template), jnp.asarray(mask),
        jnp.asarray(center, jnp.float32), jnp.float32(width), 5)
    shifts, scores = ts._mncc_grid_scores(
        torch.from_numpy(ref), torch.from_numpy(ref_mask), torch.from_numpy(template),
        torch.from_numpy(mask), torch.tensor(center), width, 5)
    np.testing.assert_allclose(shifts.numpy(), np.asarray(jshifts), rtol=0, atol=1e-6)
    jscores = np.asarray(jscores)
    np.testing.assert_array_equal(np.isneginf(scores.numpy()), np.isneginf(jscores))
    finite = np.isfinite(jscores)
    if center[1] == 60.0:
        assert not finite.any()
    np.testing.assert_allclose(scores.numpy()[finite], jscores[finite], rtol=METRIC_RTOL)


SEARCHES = [  # (metric, minimise, points_per_dim, max_recursions)
    ("masked_ssim", False, 5, 6),
    ("masked_mi", False, 5, 4),
    ("masked_ml1e", True, 4, 5),
    ("masked_mse", True, 3, 6),
    ("masked_ncc", False, 5, 3),
]


def test_compute_shift_ncc_matches_jax(pair):
    ref, template, ref_mask, mask = pair
    want = js.compute_shift_ncc(ref, template, ref_mask, mask, points_per_dim=5, max_recursions=6)
    got = ts.compute_shift_ncc(ref, template, ref_mask, mask, points_per_dim=5,
                               max_recursions=6, device="cpu")
    assert max(abs(a - b) for a, b in zip(got, want)) <= SHIFT_PX
    assert max(abs(a + b) for a, b in zip(got, TRUE_SHIFT)) <= 0.06  # JAX's test limit
    assert ts.compute_shift_ncc(ref, template, np.zeros_like(ref_mask), mask, device="cpu") == (0, 0)
    with pytest.raises(ValueError, match="points_per_dim"):
        ts.compute_shift_ncc(ref, template, ref_mask, mask, points_per_dim=2, device="cpu")


@pytest.mark.parametrize("name, minimize, points_per_dim, max_recursions", SEARCHES)
def test_compute_shift_with_metric_matches_jax(pair, name, minimize, points_per_dim,
                                               max_recursions):
    ref, template, ref_mask, mask = pair
    kw = dict(ref_image=ref, template_image=template, ref_mask=ref_mask, template_mask=mask,
              points_per_dim=points_per_dim, max_recursions=max_recursions)
    want = js.compute_shift_with_metric(getattr(jm, name), minimize, **kw)
    got = ts.compute_shift_with_metric(getattr(tm, name), minimize, device="cpu", **kw)
    assert max(abs(a - b) for a, b in zip(got, want)) <= SHIFT_PX, (got, want)


def test_compute_shift_with_metric_host_route(pair):
    """A metric that is not one of the port's batched metrics is called once
    per candidate on numpy arrays; the port's own metrics never fall back."""
    ref, template, ref_mask, mask = pair
    calls = []

    def numpy_mse(r, m, rm, mm):
        assert isinstance(m, np.ndarray) and m.shape == r.shape
        calls.append(1)
        valid = (rm > 0.5) & (mm > 0.5)
        return float(np.mean((r[valid] - m[valid]) ** 2))

    kw = dict(ref_image=ref, template_image=template, ref_mask=ref_mask, template_mask=mask,
              points_per_dim=3, max_recursions=4)
    want = js.compute_shift_with_metric(numpy_mse, True, **kw)
    n_jax = len(calls)
    got = ts.compute_shift_with_metric(numpy_mse, True, device="cpu", **kw)
    assert len(calls) - n_jax == 9 * 4
    assert max(abs(a - b) for a, b in zip(got, want)) <= SHIFT_PX
    with pytest.raises(TypeError):  # an error in a device metric is raised, not routed to the host
        ts.compute_shift_with_metric(tm.masked_ssim, False, device="cpu", bogus=1, **kw)


def test_compute_shift_pcc_matches_jax():
    """A broadband image and its exact Fourier-domain shift."""
    rng = np.random.default_rng(7)
    img = rng.random((48, 48))
    fy, fx = np.fft.fftfreq(48)[:, None], np.fft.fftfreq(48)[None, :]
    shifted = np.real(np.fft.ifft2(np.fft.fft2(img) * np.exp(-2j * np.pi * (fy * 1.3 - fx * 0.6))))
    want = js.compute_shift_pcc(img, shifted)
    got = ts.compute_shift_pcc(img, shifted, device="cpu")
    assert max(abs(a - b) for a, b in zip(got, want)) <= SHIFT_PX
    assert got == pytest.approx((-1.3, 0.6), abs=0.01)


def test_compute_shift_point_matching_matches_jax():
    pytest.importorskip("cv2")
    rng = np.random.default_rng(5)
    img = gaussian_filter(rng.random((96, 96)).astype(np.float32), 1.0)
    shifted = ndi_shift(img, (3.0, -2.0), mode="constant", order=3)
    want = js.compute_shift_point_matching(img, shifted, scale=2)
    assert ts.compute_shift_point_matching(img, shifted, scale=2) == want
    assert ts.compute_shift_point_matching(torch.from_numpy(img), torch.from_numpy(shifted),
                                           scale=2) == want


PUBLIC = [
    (tw, "cubic_shift_batch"), (tw, "linear_shift_batch"), (tw, "shift_template_batch"),
    *((tm, name) for name in (*METRICS, "perceptual_loss", "joint_counts")),
    (ts, "apply_shift_to_template"), (ts, "compute_shift_ncc"),
    (ts, "compute_shift_with_metric"), (ts, "compute_shift_pl"), (ts, "compute_shift_pcc"),
]


def test_numpy_inputs_default_to_the_card_and_tensors_stay(pair, monkeypatch):
    ref, template, ref_mask, mask = pair
    for module, name in PUBLIC:
        assert inspect.signature(getattr(module, name)).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.masked_ncc(ref, template, ref_mask, mask)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ts.compute_shift_ncc(ref, template, ref_mask, mask)
    t = [torch.from_numpy(a) for a in pair]
    assert tm.masked_ncc(*t).device.type == "cpu"
    assert tw.cubic_shift_batch(t[0][None], np.zeros((1, 2))).device.type == "cpu"
