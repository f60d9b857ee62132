"""The port's own copies of the JAX package's host code against the originals:
``config``, ``utils/imageio`` and ``data/*`` must behave byte for byte alike
(same defaults, same warnings, same files written, same arrays read, same
batches drawn)."""

import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

import highresnet_tpu.config as jax_config
import highresnet_tpu.data as jax_data
from highresnet_tpu.data.pack import pack_scene
from highresnet_tpu.data.synth import make_synthetic_dataset as jax_make_synthetic_dataset
from highresnet_tpu.utils import imageio as jax_imageio
import highresnet_tpu_torch.config as port_config
import highresnet_tpu_torch.data as port_data
from highresnet_tpu_torch.data.synth import make_synthetic_dataset as port_make_synthetic_dataset
from highresnet_tpu_torch.utils import imageio as port_imageio

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted(p.name for p in (REPO / "configs").glob("*.json"))
SYNTH = dict(n_scenes_per_channel=2, n_views=5, lr_size=12, seed=3, detail=0.2, hr_shift_sigma=1.0)


def _with_warnings(fn, *args, **kwargs):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(*args, **kwargs)
    return out, [(w.category, str(w.message)) for w in caught]


def _assert_same_imageset(a, b):
    assert a.name == b.name
    for field in ("lr", "hr", "hr_map", "clearances"):
        x, y = getattr(a, field), getattr(b, field)
        assert (x is None) == (y is None), field
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y), field


def _assert_same_batch(a, b):
    assert a.names == b.names
    for field in ("lrs", "alphas", "hrs", "hr_maps"):
        x, y = getattr(a, field), getattr(b, field)
        assert (x is None) == (y is None), field
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y), field


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return jax_make_synthetic_dataset(str(tmp_path_factory.mktemp("data") / "root"), **SYNTH)


@pytest.mark.parametrize("name", [None, *CONFIGS])
def test_load_config_matches_jax(name, tmp_path):
    path = None if name is None else str(REPO / "configs" / name)
    overrides = {"training": {"lr": 1e-4}, "extra": {"k": 1}}
    for args in ((path,), (path, overrides)):
        assert _with_warnings(port_config.load_config, *args) == _with_warnings(
            jax_config.load_config, *args)
    assert port_config.DEFAULT_CONFIG == jax_config.DEFAULT_CONFIG
    # unknown sections warn alike; "_"-prefixed ones are documentation
    odd = tmp_path / "odd.json"
    odd.write_text('{"_comment": "x", "bogus": {}, "training": {"seed": 9}}')
    got = _with_warnings(port_config.load_config, str(odd))
    assert got == _with_warnings(jax_config.load_config, str(odd)) and len(got[1]) == 1


def test_registration_config_matches_jax(tmp_path):
    assert port_config.DEFAULT_REGISTRATION_CONFIG == jax_config.DEFAULT_REGISTRATION_CONFIG
    good = tmp_path / "reg.json"
    good.write_text('{"current_deltax": 1.5, "unknown": 2}')
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    for path in (good, bad, tmp_path / "missing.json"):
        got = _with_warnings(port_config.load_registration_config, str(path))
        assert got == _with_warnings(jax_config.load_registration_config, str(path))
        assert got[1], path  # every one of these warns


def test_make_synthetic_dataset_writes_byte_identical_trees(tmp_path):
    roots = {"jax": jax_make_synthetic_dataset(str(tmp_path / "jax"), **SYNTH),
             "port": port_make_synthetic_dataset(str(tmp_path / "port"), **SYNTH)}
    trees = {k: {p.relative_to(r): p.read_bytes() for p in Path(r).rglob("*") if p.is_file()}
             for k, r in roots.items()}
    assert len(trees["jax"]) > 20 and trees["port"] == trees["jax"]


def test_imageio_matches_jax(dataset, tmp_path):
    png = next(Path(dataset).rglob("LR*.png"))
    img = port_imageio.imread_u16(png)
    assert img.dtype == np.uint16 and np.array_equal(img, jax_imageio.imread_u16(png))
    assert np.array_equal(port_imageio.img_as_float32(img), jax_imageio.img_as_float32(img))
    x = np.random.default_rng(0).random((5, 6)).astype(np.float32)
    assert np.array_equal(port_imageio.img_as_uint16(x), jax_imageio.img_as_uint16(x))
    port_imageio.imsave_u16(tmp_path / "a.png", img)
    jax_imageio.imsave_u16(tmp_path / "b.png", img)
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()


def test_scene_reading_matches_jax(dataset):
    for split in ("train", "test"):
        scenes = port_data.discover_scenes(str(Path(dataset) / split))
        assert scenes == jax_data.discover_scenes(str(Path(dataset) / split)) and len(scenes) == 4
    train = port_data.discover_scenes(str(Path(dataset) / "train"))
    # one scene read from a pack written by the JAX package, the rest from PNGs
    pack_scene(train[0])
    for scene in train:
        _assert_same_imageset(port_data.read_imageset(scene), jax_data.read_imageset(scene))
        kw = dict(create_patches=True, patch_size=6, top_k=3, beta=50.0)
        _assert_same_imageset(
            port_data.read_imageset(scene, rng=np.random.default_rng(7), **kw),
            jax_data.read_imageset(scene, rng=np.random.default_rng(7), **kw))
    assert port_data.read_baseline_cpsnr(str(Path(dataset) / "norm.csv")) == \
        jax_data.read_baseline_cpsnr(str(Path(dataset) / "norm.csv"))
    for min_l in (3, 5, 7):  # truncated, exact and alpha-padded stacks
        sets = [jax_data.read_imageset(s) for s in train]
        _assert_same_batch(port_data.collate(sets, min_l), jax_data.collate(sets, min_l))


def test_train_val_split_matches_jax_with_and_without_sklearn(dataset, monkeypatch):
    scenes = port_data.discover_scenes(str(Path(dataset) / "train")) * 5
    for seed in (1, 4):
        assert port_data.train_val_split(scenes, 0.25, seed=seed) == \
            jax_data.train_val_split(scenes, 0.25, seed=seed)
    monkeypatch.setitem(sys.modules, "sklearn.model_selection", None)  # import -> ImportError
    for seed in (1, 4):
        got = port_data.train_val_split(scenes, 0.25, seed=seed)
        assert got == jax_data.train_val_split(scenes, 0.25, seed=seed)
        assert len(got[1]) == 5


def test_batch_loader_matches_jax_over_two_epochs(dataset):
    scenes = port_data.discover_scenes(str(Path(dataset) / "train"))
    kw = dict(batch_size=3, min_l=4, top_k=4, beta=50.0, create_patches=True, patch_size=6,
              seed=11, num_workers=2, augment=True, variable_views_p=0.5)
    port, ref = port_data.BatchLoader(scenes, **kw), jax_data.BatchLoader(scenes, **kw)
    alphas = []
    for _ in range(2):
        got, want = list(port), list(ref)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            _assert_same_batch(a, b)
            alphas.append(a.alphas)
    assert port.epoch == ref.epoch == 2
    assert any((a == 0).any() for a in alphas)  # variable_views_p truncated some scene
