"""VGG19 taps, the perceptual loss and the perceptual-loss search: the port
against the JAX package on the JAX extractor's seeded weights, carried over
by ``models.convert.vgg_state_dict_from_flax`` (HWIO -> OIHW), on the CPU.

Tolerances: taps and the perceptual loss within 1e-4 of the JAX value's
magnitude (float32 convolutions in another summation order); the search's
final shift within 0.01 px.
"""

import jax
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter, shift as ndi_shift

from highresnet_tpu.models.vgg import VGGFeatureExtractor as JaxVGG
from highresnet_tpu.registration import metrics as jm
from highresnet_tpu.registration import search as js
from highresnet_tpu_torch.models.convert import vgg_state_dict_from_flax
from highresnet_tpu_torch.models.vgg import TAP_NAMES, VGGFeatureExtractor
from highresnet_tpu_torch.registration import metrics as tm
from highresnet_tpu_torch.registration import search as ts

TAP_RTOL = 1e-4
SHIFT_PX = 0.01


@pytest.fixture(scope="module")
def extractors():
    """JAX's seeded extractor and the port's, loaded with the same params."""
    jax_ex = JaxVGG(seed=0)
    port = VGGFeatureExtractor(device="cpu")
    port.module.load_state_dict(vgg_state_dict_from_flax(jax.device_get(jax_ex.params)))
    return jax_ex, port


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    ref = gaussian_filter(np.kron(rng.random((12, 12)), np.ones((4, 4))), 2.0).astype(np.float32)
    template = ndi_shift(ref, (0.7, -0.4), mode="constant", order=3).astype(np.float32)
    mask = np.zeros_like(ref)
    mask[3:-3, 3:-3] = 1
    return ref, template, mask


def assert_taps_close(port_taps, jax_taps):
    assert sorted(port_taps, key=int) == TAP_NAMES == sorted(jax_taps, key=int)
    for name, want in jax_taps.items():
        want = np.asarray(want).transpose(0, 3, 1, 2)  # NHWC -> NCHW
        got = port_taps[name].numpy()
        assert got.shape == want.shape, name
        assert np.abs(got - want).max() <= TAP_RTOL * np.abs(want).max(), name


def test_vgg_taps_match_jax(extractors):
    jax_ex, port = extractors
    rng = np.random.default_rng(1)
    img = rng.random((32, 32), dtype=np.float32)
    assert_taps_close(port(img), jax_ex(img))
    stack = rng.random((3, 32, 32), dtype=np.float32)
    assert_taps_close(port.features_batched(stack), jax_ex.features_batched(stack))
    assert port(img)["28"].shape == (1, 512, 2, 2)


def test_vgg_weight_files_load_as_in_jax(extractors, tmp_path):
    """A torchvision-style state dict, as .pth and through the export CLI's
    .npz, loads into both extractors with the same taps."""
    from highresnet_tpu.cli.export_vgg_weights import main as jax_export
    from highresnet_tpu_torch.cli.export_vgg_weights import main as port_export

    jax_ex, _ = extractors
    pth = tmp_path / "vgg19.pth"
    state = vgg_state_dict_from_flax(jax.device_get(jax_ex.params))
    state["classifier.0.weight"] = torch.zeros(2, 2)  # not a conv of the stack: ignored
    torch.save(state, pth)
    taps = port_export(["--torch-weights", str(pth), "--out", str(tmp_path / "port.npz"),
                        "--device", "cpu"])
    jax_export(["--torch-weights", str(pth), "--out", str(tmp_path / "jax.npz")])
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in a.files)
    assert taps["28"].shape == (1, 512, 4, 4)  # the CLI's 64 px probe
    img = np.random.default_rng(3).random((32, 32), dtype=np.float32)
    from_npz = VGGFeatureExtractor(weights_path=str(tmp_path / "port.npz"), device="cpu")(img)
    assert_taps_close(from_npz, JaxVGG(weights_path=str(tmp_path / "port.npz"))(img))
    from_pth = VGGFeatureExtractor(weights_path=str(pth), device="cpu")(img)
    assert all(torch.equal(from_pth[k], from_npz[k]) for k in from_npz)


def test_seeded_extractor_is_reproducible_and_leaves_the_global_rng(extractors):
    state = torch.random.get_rng_state()
    a, b = VGGFeatureExtractor(seed=0, device="cpu"), VGGFeatureExtractor(seed=0, device="cpu")
    c = VGGFeatureExtractor(seed=1, device="cpu")
    assert torch.equal(torch.random.get_rng_state(), state)
    img = np.random.default_rng(2).random((32, 32), dtype=np.float32)
    assert torch.equal(a(img)["28"], b(img)["28"])
    assert not torch.equal(a(img)["28"], c(img)["28"])
    # lecun-normal scale, as flax draws it: conv 0's kernel std ~ sqrt(1/27)
    w = a.module.features[0].weight
    assert float(w.std()) == pytest.approx((1 / 27) ** 0.5, rel=0.2)
    assert not any(p.requires_grad for p in a.module.parameters())


def test_perceptual_loss_matches_jax(extractors, pair):
    jax_ex, port = extractors
    ref, template, mask = pair
    want, jax_diffs = jm.perceptual_loss(ref, template, mask, mask, jax_ex)
    got, diffs = tm.perceptual_loss(ref, template, mask, mask, port, device="cpu")
    assert got == pytest.approx(want, rel=TAP_RTOL)
    assert sorted(diffs) == sorted(jax_diffs)
    for key, value in jax_diffs.items():
        if key.endswith("_loss"):
            assert diffs[key] == pytest.approx(value, rel=TAP_RTOL), key
        elif key.endswith("_mask"):
            np.testing.assert_array_equal(diffs[key], np.asarray(value))
        else:
            np.testing.assert_allclose(diffs[key], np.asarray(value), rtol=0,
                                       atol=TAP_RTOL * np.abs(value).max())
    same, _ = tm.perceptual_loss(ref, ref, mask, mask, port, device="cpu")
    assert same == 0.0


@pytest.mark.parametrize("points_per_dim, max_recursions", [(3, 3), (5, 4)])
def test_compute_shift_pl_matches_jax(extractors, pair, points_per_dim, max_recursions):
    jax_ex, port = extractors
    ref, template, mask = pair
    want = js.compute_shift_pl(jax_ex, ref, template, mask, mask, points_per_dim, max_recursions)
    got = ts.compute_shift_pl(port, ref, template, mask, mask, points_per_dim, max_recursions,
                              device="cpu")
    assert max(abs(a - b) for a, b in zip(got, want)) <= SHIFT_PX, (got, want)


def test_vgg_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VGGFeatureExtractor()
