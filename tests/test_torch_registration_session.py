"""The registration session, scene preprocessing, display helpers and the Qt
app of the port, against the JAX package on the same seeded inputs (CPU).

The sessions share the JAX extractor's seeded VGG weights (carried over by
``vgg_state_dict_from_flax``). Shifts within 0.01 px, recorded metrics
within rtol 1e-4, 8-bit overlays byte for byte, aligned PNGs within one
16-bit count (a float32 warp within 1e-6 times 65535, truncated).
"""

import json
import os

import matplotlib

matplotlib._called_from_test = True
matplotlib.use("Agg")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from scipy.ndimage import gaussian_filter, shift as ndi_shift  # noqa: E402

from highresnet_tpu.models.vgg import VGGFeatureExtractor as JaxVGG  # noqa: E402
from highresnet_tpu.registration import metrics as jm  # noqa: E402
from highresnet_tpu.registration.session import RegistrationSession as JaxSession  # noqa: E402
from highresnet_tpu.utils import display as jd  # noqa: E402
from highresnet_tpu_torch.models.convert import vgg_state_dict_from_flax  # noqa: E402
from highresnet_tpu_torch.models.vgg import VGGFeatureExtractor  # noqa: E402
from highresnet_tpu_torch.registration.session import (  # noqa: E402
    OVERLAY_MODES,
    SEARCH_METHODS,
    RegistrationSession,
)
from highresnet_tpu_torch.utils import display as td  # noqa: E402

SHIFT_PX = 0.01
METRIC_RTOL = 1e-4
METRIC_KEYS = ("ml1e", "pl", "ssim", "nmi", "ncc")


@pytest.fixture(scope="module")
def extractors():
    jax_ex = JaxVGG(seed=0)
    port = VGGFeatureExtractor(device="cpu")
    port.module.load_state_dict(vgg_state_dict_from_flax(jax.device_get(jax_ex.params)))
    return jax_ex, port


def smooth_pair(size=48, seed=0):
    rng = np.random.default_rng(seed)
    ref = gaussian_filter(np.kron(rng.random((size // 4, size // 4)), np.ones((4, 4))), 2.0)
    ref = ref.astype(np.float32)
    template = ndi_shift(ref, (0.6, -0.4), mode="constant", order=3).astype(np.float32)
    mask = np.zeros_like(ref)
    mask[3:-3, 3:-3] = 1
    return ref, template, mask, mask


def fourier_pair(size=48):
    img = np.random.default_rng(7).random((size, size))
    fy, fx = np.fft.fftfreq(size)[:, None], np.fft.fftfreq(size)[None, :]
    moved = np.real(np.fft.ifft2(np.fft.fft2(img) * np.exp(-2j * np.pi * (fy * 0.6 - fx * 0.4))))
    ones = np.ones((size, size), np.float32)
    return img.astype(np.float32), moved.astype(np.float32), ones, ones


def sessions(extractors, arrays):
    jax_s = JaxSession(perceptual_model=extractors[0])
    port = RegistrationSession(perceptual_model=extractors[1], device="cpu")
    jax_s.set_arrays(*arrays)
    port.set_arrays(*arrays)
    return jax_s, port


def assert_histories_close(port, jax_s, jax_ex):
    """The recorded shifts within SHIFT_PX; the last recorded metrics equal to
    JAX's metric functions on the port's own warped template (MI's bins jump
    when a warp moves a pixel by one ulp across a bin edge, so the two
    sessions' metrics are held on the same inputs); the port's warped
    template at JAX's shift within 1e-6 of JAX's."""
    assert len(port.history["pl"]) == len(jax_s.history["pl"])
    for key in ("shift_y", "shift_x"):
        np.testing.assert_allclose(port.history[key], jax_s.history[key], rtol=0, atol=SHIFT_PX)
    img, msk = (t.numpy() for t in port.shifted_template())
    args = (port.ref_image.numpy(), img, port.ref_mask.numpy(), msk)
    want = {"ml1e": jm.masked_ml1e(*args), "pl": jm.perceptual_loss(*args, jax_ex)[0],
            "ssim": jm.masked_ssim(*args), "nmi": jm.masked_mi(*args), "ncc": jm.masked_ncc(*args)}
    for key in METRIC_KEYS:
        assert port.history[key][-1] == pytest.approx(float(want[key]), rel=METRIC_RTOL), key
    port.config["current_deltay"], port.config["current_deltax"] = jax_s.current_shift
    (img, msk), (jimg, jmsk) = port.shifted_template(), jax_s.shifted_template()
    np.testing.assert_allclose(img.numpy(), jimg, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(msk.numpy(), jmsk)


METHOD_CASES = [
    ("Fourier", {}),
    ("Point Matching", {"scale": 2}),
    ("NCC", {"points_per_dim": 5, "max_recursions": 5}),
    ("Perceptual Loss", {"points_per_dim": 3, "max_recursions": 3}),
    ("SSIM", {"points_per_dim": 5, "max_recursions": 4}),
    ("Mutual Information", {"points_per_dim": 5, "max_recursions": 4}),
    ("Mean L1 Error", {"points_per_dim": 4, "max_recursions": 5}),
]


@pytest.mark.parametrize("method, kwargs", METHOD_CASES)
def test_session_methods_match_jax(extractors, method, kwargs):
    """Each of the seven methods from the same start: the solved shift and
    the metrics recorded at it."""
    assert [m for m, _ in METHOD_CASES] == list(SEARCH_METHODS)
    if method == "Fourier":
        arrays = fourier_pair()
    elif method == "Point Matching":
        arrays = smooth_pair(96, seed=5)
    else:
        arrays = smooth_pair()
    jax_s, port = sessions(extractors, arrays)
    want = jax_s.compute_and_apply_shift(method, **kwargs)
    got = port.compute_and_apply_shift(method, **kwargs)
    assert max(abs(a - b) for a, b in zip(got, want)) <= SHIFT_PX, (got, want)
    assert_histories_close(port, jax_s, extractors[0])
    assert port.ref_image.device.type == "cpu" and isinstance(port.ref_image, torch.Tensor)
    with pytest.raises(ValueError, match="unknown method"):
        port.compute_and_apply_shift("nope")


def test_session_overlays_vote_and_heatmap_match_jax(extractors):
    jax_s, port = sessions(extractors, smooth_pair())
    for s in (jax_s, port):
        s.nudge(dy=0.1, dx=-0.2)
    assert port.current_shift == jax_s.current_shift == (0.1, -0.2)
    for nudge in ((0.0, 0.0), (-0.1, 0.2), (1.0, -1.0)):  # fractional, zero and integer shifts
        for s in (jax_s, port):
            s.nudge(*nudge)
        for mode in OVERLAY_MODES:
            got, want = port.overlay(mode), jax_s.overlay(mode)
            assert got.dtype == want.dtype == np.uint8, mode
            np.testing.assert_array_equal(got, want, err_msg=f"{mode} at {port.current_shift}")
    with pytest.raises(ValueError, match="unknown overlay"):
        port.overlay("nope")

    for s in (jax_s, port):  # solve, worsen, record, vote back
        s.config["current_deltay"] = s.config["current_deltax"] = 0.0
        s.reset_history()
        s.compute_and_apply_shift("NCC", points_per_dim=5, max_recursions=5)
        s.nudge(dy=1.0)
        s.record_metrics()
    voted, jax_voted = port.vote_best_shift(), jax_s.vote_best_shift()
    assert voted == (port.history["shift_y"][0], port.history["shift_x"][0])
    assert max(abs(a - b) for a, b in zip(voted, jax_voted)) <= SHIFT_PX
    np.testing.assert_allclose(port.vgg_diff_heatmap(), jax_s.vgg_diff_heatmap(), rtol=0,
                               atol=1e-4)
    port.reset_history()
    with pytest.raises(RuntimeError, match="no shifts recorded"):
        port.vote_best_shift()


def test_session_loads_files_as_jax_does(extractors, tmp_path):
    from highresnet_tpu_torch.utils.imageio import imsave_u16

    rng = np.random.default_rng(3)
    img = (rng.random((32, 32)) * 65535).astype(np.uint16)
    mask = (rng.random((32, 32)) > 0.3).astype(np.uint8) * 255
    imsave_u16(str(tmp_path / "img.png"), img)
    imsave_u16(str(tmp_path / "mask.png"), mask)
    jax_s, port = JaxSession(), RegistrationSession(device="cpu")
    for s in (jax_s, port):
        s.load_reference(str(tmp_path / "img.png"), str(tmp_path / "mask.png"))
        s.load_template(str(tmp_path / "img.png"))
    for attr in ("ref_image", "ref_mask", "template_image", "template_mask"):
        np.testing.assert_array_equal(getattr(port, attr).numpy(), getattr(jax_s, attr))


def test_session_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RegistrationSession()


def test_display_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.random((16, 16)) * 100
    mask = np.zeros((16, 16))
    mask[:6] = 1
    for fn, args in (
        ("rescale_intensity", (img, (25, 75))),
        ("rescale_intensity", (img, (5, 5))),
        ("min_max_scale", (img,)),
        ("contrast_stretch_8bit", (img,)),
        ("contrast_stretch_8bit", (img, mask)),
        ("contrast_stretch_8bit", (img, np.zeros((16, 16)))),
        ("process_image_for_display", (np.stack([img] * 3, -1),)),
        ("process_image_for_display", (img,)),
    ):
        np.testing.assert_array_equal(getattr(td, fn)(*args), getattr(jd, fn)(*args), err_msg=fn)
    diffs = {"0_diff": rng.random((16, 16)), "5_diff": rng.random((8, 8)),
             "10_diff": rng.random((4, 4)), "0_loss": 1.0}
    np.testing.assert_allclose(td.compute_sum_of_layers(diffs), jd.compute_sum_of_layers(diffs),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(td._resize(diffs["5_diff"], (24, 20)),
                               jd._resize(diffs["5_diff"], (24, 20)), rtol=0, atol=1e-6)
    assert td.compute_sum_of_layers(None).shape == (10, 10)

    f = rng.random((16, 16)).astype(np.float32) * 65535
    for name, image, kw in (("f", f, {"dtype": np.float32}), ("b", f > 30000, {"dtype": np.bool_}),
                            ("u8", f / 256, {"dtype": np.uint8}), ("d", f / 256, {"easy_display": True})):
        td.save_image(image, str(tmp_path / "port" / f"{name}.png"), **kw)
        jd.save_image(image, str(tmp_path / "jax" / f"{name}.png"), **kw)
        np.testing.assert_array_equal(td.read_image(str(tmp_path / "port" / f"{name}.png")),
                                      jd.read_image(str(tmp_path / "jax" / f"{name}.png")))
    td.save_shift((1.25, -0.5), str(tmp_path / "s" / "shift.json"))
    assert jd.load_shift(str(tmp_path / "s" / "shift.json")) == td.load_shift(
        str(tmp_path / "s" / "shift.json")) == (1.25, -0.5)


def test_plots_and_heatmap_canvas_render(tmp_path):
    from highresnet_tpu_torch.data import discover_scenes, make_synthetic_dataset, read_imageset
    from highresnet_tpu_torch.utils.heatmap_canvas import HeatmapCanvas

    make_synthetic_dataset(str(tmp_path), n_scenes_per_channel=1, n_views=3, lr_size=16, seed=5,
                           splits=("train",))
    scene = read_imageset(discover_scenes(f"{tmp_path}/train")[0])
    assert td.imsetshow(scene, show=False) is not None
    fig = td.plot_metrics_vs_shifts([0, 1], [0, 1], [1, 0.9], [0.1, 0.2], [0.3, 0.2],
                                    highlight_last=True, show=False)
    assert len(fig.axes) == 6
    canvas = HeatmapCanvas()
    data = np.random.default_rng(0).random((10, 10))
    canvas.show_heatmap(data, data > 0.5)
    canvas.show_heatmap(data * 2)  # the colorbar is reused
    canvas.show_image((data * 255).astype(np.uint8))
    canvas.save(str(tmp_path / "c.png"))
    assert (tmp_path / "c.png").exists()


def test_preprocess_imgset_matches_jax(tmp_path):
    from highresnet_tpu.registration.preprocess import downscale_hr as jax_downscale
    from highresnet_tpu.registration.preprocess import preprocess_imgset as jax_preprocess
    from highresnet_tpu_torch.data import discover_scenes, make_synthetic_dataset, read_imageset
    from highresnet_tpu_torch.registration.preprocess import downscale_hr, preprocess_imgset
    from highresnet_tpu_torch.utils.imageio import imread_u16

    make_synthetic_dataset(str(tmp_path), n_scenes_per_channel=1, n_views=3, lr_size=24, seed=4,
                           splits=("train",))
    scene = discover_scenes(f"{tmp_path}/train")[0]
    imset = read_imageset(scene)
    ref, ref_mask = downscale_hr(imset.hr, imset.hr_map, device="cpu")
    jref, jmask = jax_downscale(imset.hr, imset.hr_map)
    np.testing.assert_allclose(ref, jref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ref_mask, jmask)

    kw = dict(points_per_dim=3, max_recursions=3)
    got = preprocess_imgset(scene, out_subdir="port", device="cpu", **kw)
    want = jax_preprocess(scene, out_subdir="jax", **kw)
    assert sorted(got) == sorted(want) == ["000", "001", "002"]
    for view in got:
        assert max(abs(a - b) for a, b in zip(got[view], want[view])) <= SHIFT_PX
    files = sorted(os.listdir(os.path.join(scene, "port")))
    assert files == sorted(os.listdir(os.path.join(scene, "jax")))
    assert len(files) == 1 + 3 * 3
    for name in files:
        a, b = (os.path.join(scene, d, name) for d in ("port", "jax"))
        if name.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                sa, sb = json.load(fa), json.load(fb)
            assert sa == pytest.approx(sb, abs=SHIFT_PX)
        else:
            diff = np.abs(imread_u16(a).astype(np.int64) - imread_u16(b).astype(np.int64))
            assert diff.max() <= (0 if name.startswith("QM") else 1), name


def test_gui_wiring_with_stubbed_qt(tmp_path, monkeypatch):
    """The port's app.py widget wiring against the port's session (CPU),
    through the fake PyQt5 of tests/qt_stub.py, as the JAX app's test does;
    then ``main`` sets the device up before any other work."""
    import qt_stub

    qt_stub.install()
    try:
        from PyQt5 import QtCore  # the stub

        from highresnet_tpu_torch.registration import app
        from highresnet_tpu_torch.utils.imageio import imsave_u16

        rng = np.random.default_rng(0)
        ref = rng.random((32, 32)).astype(np.float32)
        session = RegistrationSession(device="cpu")
        session.set_arrays(ref, np.roll(ref, 1, axis=1))

        win = app.build_main_window(session)
        assert win.tabs.count() == 3
        assert set(app.GRID_METHODS) <= set(SEARCH_METHODS)
        win.method.setCurrentText("Point Matching")
        assert win.n_keypoints.isVisible() and not win.points_per_dim.isVisible()
        win.method.setCurrentText("NCC")
        assert win.points_per_dim.isVisible() and not win.n_keypoints.isVisible()

        win.delta_x.setText("0.25")
        win.delta_y.setText("-0.5")
        win.on_delta_edited()
        assert session.current_shift == (-0.5, 0.25)
        win.keyPressEvent(qt_stub.KeyEvent(QtCore.Qt.Key_Right))
        assert session.config["current_deltax"] == pytest.approx(
            0.25 + session.config["shift_step_x"])

        win.points_per_dim.setValue(3)
        win.max_recursions.setValue(3)
        win.on_solve()
        assert "applied shift" in win.statusBar().messages[-1]
        win.on_vote()
        assert "vote winner" in win.statusBar().messages[-1]
        win.tabs.setCurrentIndex(2)  # Metric History
        assert isinstance(win.plots_holder._widget, qt_stub._FakeFigureCanvas)
        win.tabs.setCurrentIndex(1)  # VGG Diff
        win.tabs.setCurrentIndex(0)
        win.on_reset_history()
        assert session.history["pl"] == []

        p = tmp_path / "ref.png"
        imsave_u16(str(p), (ref * 65535).astype(np.uint16))
        qt_stub.QFileDialog.next_path = str(p)
        win.on_load_reference()
        assert session.config["reference_image"] == str(p)
        win.on_load_template()
        assert session.config["template_image"] == str(p)
        qt_stub.QFileDialog.next_path = ""
        win.on_load_reference()

        calls = []
        real_setup, real_qt = app.setup_device, app._require_qt
        monkeypatch.setattr(app, "setup_device", lambda d: calls.append(d) or real_setup(d))
        monkeypatch.setattr(app, "_require_qt", lambda: calls.append("qt") or real_qt())
        cfg = tmp_path / "config.json"
        cfg.write_text(json.dumps({"reference_image": str(p), "template_image": str(p)}))
        with pytest.raises(SystemExit):
            app.main(str(cfg), device="cpu")
        assert calls[:2] == ["cpu", "qt"]
    finally:
        qt_stub.uninstall()
