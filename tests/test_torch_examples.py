"""The quality-experiment drivers (``highresnet_tpu_torch/examples/``) against
the JAX package on the CPU.

Each scoring leg runs through the port driver's own function and through the
same loop built from the JAX package's calls, as the JAX driver makes them,
on one set of weights: JAX HRNet params initialised from a seed, converted by
``models/convert.py::hrnet_state_dict_from_flax``. Per scene within the 0.01
dB parity contract: MFSR / one view / bicubic, the views sweep, the TTA arms,
the fractional search, the ensemble rows and the stacking. Also the
precision ablation (f32 at f32 tolerance, bf16/mixed within 2x of JAX's,
the same conclusion), the report schemas against the checked-in JAX
reports, ``recipe_report`` byte for byte against the JAX script, the
drivers' default outputs and devices, ``display_dataset``, ``test_model``,
``pipeline_bench``, and ``train_val_split``'s two branches at the drivers'
scene counts. Small sizes: a one-residual-layer HRNet with 16 channels, 4
views of 16 px (SR 48 px), four scenes; one jitted JAX forward serves every
test, so each input shape compiles once.
"""

import builtins
import itertools
import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from highresnet_tpu.data import collate as jax_collate
from highresnet_tpu.data import read_imageset as jax_read_imageset
from highresnet_tpu.models.hrnet import HRNet as JaxHRNet
from highresnet_tpu.ops.metrics import cpsnr as jax_cpsnr
from highresnet_tpu.ops.metrics import shift_cpsnr as jax_shift_cpsnr
from highresnet_tpu_torch.data import discover_scenes, make_synthetic_dataset
from highresnet_tpu_torch.eval.evaluator import Forward
from highresnet_tpu_torch.models.convert import hrnet_state_dict_from_flax
from highresnet_tpu_torch.models.hrnet import HRNet

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
PARITY_DB = 0.01
L = 4
NET = {
    "encoder": {"in_channels": 2, "num_layers": 1, "kernel_size": 3, "channel_size": 16},
    "recursive": {"alpha_residual": True, "in_channels": 16, "kernel_size": 3},
    "decoder": {
        "deconv": {"in_channels": 16, "kernel_size": 3, "stride": 3, "out_channels": 16},
        "final": {"in_channels": 16, "kernel_size": 1, "out_channels": 1},
    },
}
DRIVERS = ("quality_report", "test_model", "display_dataset", "quality_experiment",
           "views_ablation", "register_ablation", "tta_experiment", "flagship_recipe",
           "ensemble_experiment", "recipe_report", "flagship_config_report",
           "precision_ablation", "pipeline_bench")
HOST_ONLY = ("display_dataset", "recipe_report", "pipeline_bench")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs files side by side."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Four misaligned synthetic scenes, 4 views of 16 px."""
    root = str(tmp_path_factory.mktemp("examples"))
    make_synthetic_dataset(root, n_scenes_per_channel=2, n_views=L, lr_size=16, seed=3,
                           hr_shift_sigma=1.25, splits=("train",))
    return root, discover_scenes(f"{root}/train")


_JAX_HRNET = JaxHRNet(config=NET)
_JAX_INIT = jax.jit(_JAX_HRNET.init)
_JAX_APPLY = jax.jit(lambda p, lrs, al: _JAX_HRNET.apply({"params": p}, lrs, al))


def _jax_read(scene_dir, views):
    """The JAX package's scene read with the port drivers' seeded view draw."""
    from highresnet_tpu_torch.exp.harness import VIEW_SEED

    return jax_read_imageset(scene_dir, top_k=views, beta=50.0,
                             rng=np.random.default_rng(VIEW_SEED))


def _jax_params(seed: int):
    return _JAX_INIT(jax.random.PRNGKey(seed), jnp.zeros((1, L, 16, 16)), jnp.ones((1, L)))["params"]


def _port_model(params) -> HRNet:
    model = HRNet(NET)
    model.load_state_dict(hrnet_state_dict_from_flax(params))
    return model.eval()


@pytest.fixture(scope="module")
def weights():
    """Three seeded JAX weight sets and the port models holding them."""
    params = {s: _jax_params(s) for s in (0, 1, 2)}
    return params, {s: _port_model(p) for s, p in params.items()}




def _jax_fwd(params):
    """The JAX drivers' jitted forward, one jit for every weight set."""
    return lambda lrs, al: _JAX_APPLY(params, jnp.asarray(lrs), jnp.asarray(al))


def _jax_score(s):
    hr, hrm = jnp.asarray(s.hr), jnp.asarray(s.hr_map)
    return lambda img: float(jax_shift_cpsnr(jnp.clip(jnp.asarray(img), 0, 1), hr, hrm))


def _jax_bicubic(img):
    h, w = img.shape
    return jax.image.resize(jnp.asarray(img), (3 * h, 3 * w), method="cubic")


def _close(got, want, what):
    assert len(got) == len(want) > 0, what
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.isfinite(want).all() and diff.max() <= PARITY_DB, (what, diff.max())


# --------------------------------------------------------------------------
# scoring legs against the JAX package


def test_mfsr_rows_match_jax(data, weights, tmp_path):
    """quality_report / quality_experiment: MFSR, one view and bicubic per
    scene; quality_report's main on a run dir holding the weights."""
    from highresnet_tpu_torch.examples import quality_report
    from highresnet_tpu_torch.exp import harness

    root, scenes = data
    params, models = weights
    got = harness.mfsr_rows(Forward.plain(models[0], CPU, host=False), scenes, L, "cpu")
    fwd = _jax_fwd(params[0])
    for row, d in zip(got, scenes):
        s = _jax_read(d, L)
        batch, one = jax_collate([s], L), jax_collate([s], 1)
        score = _jax_score(s)
        want = (score(fwd(batch.lrs, batch.alphas)[0]), score(fwd(one.lrs, one.alphas)[0]),
                score(_jax_bicubic(s.lr[0])))
        assert row["scene"] == s.name
        _close([row["mfsr"], row["one_view"], row["bicubic"]], want, s.name)

    run = tmp_path / "run" / "best"
    run.mkdir(parents=True)
    torch.save(models[0].state_dict(), run / "HRNet.pth")
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({"network": NET}))
    rows = quality_report.main(["--data", root, "--checkpoint", str(run.parent), "--config",
                                str(cfg), "--views", str(L), "--device", "cpu"])
    val = harness.held_out_scenes(root, 0.25)
    assert [r["scene"] for r in rows] == [Path(d).name for d in val] and len(rows) == 1
    by_name = {r["scene"]: r for r in got}
    for r in rows:
        assert r == by_name[r["scene"]]


def test_views_sweep_matches_jax(data, weights):
    from highresnet_tpu_torch.examples.views_ablation import sweep

    _, scenes = data
    params, models = weights
    views = (1, 2, 4)
    got = sweep(Forward.plain(models[1], CPU, host=False), scenes[:2], views, "cpu")
    fwd = _jax_fwd(params[1])
    want = {k: [] for k in views}
    overflow = {k: [] for k in views}
    cubic = []
    for d in scenes[:2]:
        s = _jax_read(d, max(views))
        score = _jax_score(s)
        for k in views:
            batch = jax_collate([s], k)
            sr = fwd(batch.lrs, batch.alphas)[0]
            want[k].append(score(sr))
            overflow[k].append(max(0.0, float(jnp.maximum(jnp.max(sr - 1.0), jnp.max(-sr)))))
        cubic.append(score(_jax_bicubic(s.lr[0])))
    for k in views:
        _close(got["per_k"][k], want[k], f"{k} views")
        np.testing.assert_allclose(got["overflow"][k], overflow[k], rtol=1e-4, atol=2e-5)
    _close(got["bicubic"], cubic, "bicubic")


def test_tta_rows_match_jax(data, weights):
    """tta_experiment: single / naive8 / reg8 / naive4 / reg4 per scene from
    one batched scorer, against the JAX driver's jitted batch scorer."""
    from highresnet_tpu.ops.dihedral import dihedral_fwd, dihedral_inv
    from highresnet_tpu.ops.metrics import shift_cpsnr_batch
    from highresnet_tpu.registration.search import pcc_align_batch
    from highresnet_tpu_torch.examples.tta_experiment import ARMS, run_split

    _, scenes = data
    params, models = weights
    rows, summary = run_split(Forward.plain(models[2], CPU, host=False), scenes, L, 4, "val")
    assert summary["n_scenes"] == len(scenes) == 4 and len(summary["per_transform_offset_px"]) == 7
    hrnet = _JAX_HRNET

    @jax.jit
    def batch_scores(p, lrs, al, hr, hrm):  # examples/tta_experiment.py:69-95
        srs = jnp.stack([dihedral_inv(hrnet.apply({"params": p}, dihedral_fwd(lrs, t), al), t)
                         for t in range(8)])
        _, b, h, w = srs.shape
        anchor = srs[0]
        ref = jnp.broadcast_to(anchor[None], (7, b, h, w)).reshape(7 * b, h, w)
        aligned, _ = pcc_align_batch(ref, srs[1:].reshape(7 * b, h, w))
        reg = jnp.concatenate([anchor[None], aligned.reshape(7, b, h, w)])
        sub = jnp.array([0, 2, 4, 6])
        arms = jnp.stack([anchor, jnp.mean(srs, axis=0), jnp.mean(reg, axis=0),
                          jnp.mean(srs[sub], axis=0), jnp.mean(reg[sub], axis=0)])
        return jax.vmap(lambda a: shift_cpsnr_batch(jnp.clip(a, 0.0, 1.0), hr, hrm))(arms)

    want = []
    for i in range(0, len(scenes), 4):
        sets = [_jax_read(d, L) for d in scenes[i:i + 4]]
        bt = jax_collate(sets, L)
        scores = np.asarray(batch_scores(params[2], jnp.asarray(bt.lrs), jnp.asarray(bt.alphas),
                                         jnp.asarray(bt.hrs), jnp.asarray(bt.hr_maps)))
        want += [{"scene": s.name, **{a: float(scores[k, j]) for k, a in enumerate(ARMS)}}
                 for j, s in enumerate(sets)]
    assert [r["scene"] for r in rows] == [r["scene"] for r in want]
    for arm in ARMS:
        _close([r[arm] for r in rows], [r[arm] for r in want], arm)


def test_frac_cpsnr_matches_jax(data, weights):
    """register_ablation: the fractional search over 625 Lanczos placements
    (0.25 px over ±3 px) and the integer search, per scene."""
    from highresnet_tpu.ops.lanczos import lanczos_shift
    from highresnet_tpu_torch.examples.register_ablation import frac_grid, score_arm

    _, scenes = data
    params, models = weights
    grid = frac_grid("cpu")
    assert grid.shape == (625, 2) and float(grid.abs().max()) == 3.0
    int_got, frac_got = score_arm(Forward.plain(models[0], CPU, host=False), scenes[:2], L, "cpu")
    grid_j = jnp.asarray(grid.numpy())

    @jax.jit
    def frac_cpsnr(sr, hr, hr_map, border=3):  # examples/register_ablation.py:123-142
        n = grid_j.shape[0]
        warped = lanczos_shift(jnp.broadcast_to(sr, (n,) + sr.shape), grid_j)
        size = sr.shape[-1] - 2 * border
        sr_c = warped[:, border:border + size, border:border + size]
        hr_c = hr[border:border + size, border:border + size]
        map_c = hr_map[border:border + size, border:border + size]
        return jnp.max(jax_cpsnr(jnp.clip(sr_c, 0, 1), hr_c[None], map_c[None]))

    fwd = _jax_fwd(params[0])
    int_want, frac_want = [], []
    for d in scenes[:2]:
        s = _jax_read(d, L)
        batch = jax_collate([s], L)
        sr = fwd(batch.lrs, batch.alphas)[0]
        int_want.append(_jax_score(s)(sr))
        frac_want.append(float(frac_cpsnr(sr, jnp.asarray(s.hr), jnp.asarray(s.hr_map))))
    _close(int_got, int_want, "integer search")
    _close(frac_got, frac_want, "fractional search")


def test_flagship_scoring_matches_jax(data, weights):
    """flagship_recipe: plain forward and x8 registered TTA per fresh scene,
    against the JAX evaluator's ``_TTAForward``."""
    from highresnet_tpu.eval.evaluator import _TTAForward as JaxTTA
    from highresnet_tpu_torch.examples.flagship_recipe import score_test_set

    _, scenes = data
    params, models = weights
    got = score_test_set(models[1], scenes[:2], L, "cpu")
    fwd, tta = _jax_fwd(params[1]), JaxTTA(_JAX_HRNET, params[1], transforms=8, register=True)
    want = {"plain_fwd": [], "tta8": []}
    for d in scenes[:2]:
        s = _jax_read(d, L)
        batch = jax_collate([s], L)
        score = _jax_score(s)
        want["plain_fwd"].append(score(fwd(batch.lrs, batch.alphas)[0]))
        want["tta8"].append(score(jnp.asarray(tta(np.asarray(batch.lrs),
                                                  np.asarray(batch.alphas)))[0]))
    for k in want:
        _close(got[k], want[k], k)


def _jax_ensemble(params, best_val, scenes, tta: int):
    """examples/ensemble_experiment.py:215-339's loop and stacking on the JAX
    package's calls."""
    from highresnet_tpu.ops.dihedral import dihedral_fwd, dihedral_inv
    from highresnet_tpu.registration.search import pcc_align_batch

    seeds = list(params)
    hrnet, fwd = _JAX_HRNET, _JAX_APPLY

    @jax.jit
    def tta_fwd(p, lrs, al):
        srs = [dihedral_inv(hrnet.apply({"params": p}, dihedral_fwd(lrs, t), al), t)
               for t in range(tta)]
        anchor = srs[0]
        srs = [anchor] + [pcc_align_batch(anchor, sr)[0] for sr in srs[1:]]
        return jnp.mean(jnp.stack(srs), axis=0)

    pair_keys = list(itertools.combinations(seeds, 2))
    anchor = sorted(seeds, key=lambda s_: best_val[s_])[0]
    rows, scene_data = [], []
    for d in scenes:
        s = _jax_read(d, L)
        batch = jax_collate([s], L)
        lrs, al = jnp.asarray(batch.lrs), jnp.asarray(batch.alphas)
        srs = {seed: fwd(params[seed], lrs, al)[0] for seed in seeds}
        score = _jax_score(s)
        row = {"scene": s.name, **{f"seed{seed}": score(srs[seed]) for seed in seeds}}
        ttas = {seed: tta_fwd(params[seed], lrs, al)[0] for seed in seeds}
        for seed in seeds:
            row[f"tta{seed}"] = score(ttas[seed])
        t_anchor = ttas[anchor]
        row["full_stack"] = score(jnp.mean(jnp.stack([t_anchor] + [
            pcc_align_batch(t_anchor[None], ttas[s_][None])[0][0]
            for s_ in seeds if s_ != anchor]), axis=0))
        for a, b in pair_keys:
            a0, b0 = sorted((a, b), key=lambda s_: best_val[s_])
            row[f"ens{a}{b}"] = score((srs[a] + srs[b]) / 2.0)
            aligned, _ = pcc_align_batch(srs[a0][None], srs[b0][None])
            row[f"rens{a}{b}"] = score((srs[a0] + aligned[0]) / 2.0)
        stack = jnp.stack([srs[anchor]] + [pcc_align_batch(srs[anchor][None], srs[s_][None])[0][0]
                                           for s_ in seeds if s_ != anchor])
        row["ens_all"] = score(jnp.mean(jnp.stack(list(srs.values())), axis=0))
        row["rens_all"] = score(jnp.mean(stack, axis=0))
        scene_data.append((np.asarray(stack), np.asarray(s.hr), np.asarray(s.hr_map)))
        rows.append(row)
    k, c = len(seeds), 8
    G, rhs = np.zeros((k, k)), np.zeros(k)
    for stack, hr, hrm in scene_data[0::2]:
        hr_a = np.asarray(pcc_align_batch(stack[:1], hr[None])[0][0])
        X = stack[:, c:-c, c:-c].reshape(k, -1)
        m = hrm[c:-c, c:-c].reshape(-1) > 0
        X = X[:, m] - X[:, m].mean(axis=1, keepdims=True)
        y = hr_a[c:-c, c:-c].reshape(-1)[m]
        y = y - y.mean()
        G += X @ X.T
        rhs += X @ y
    w = np.linalg.solve(G, rhs)
    stacked = [float(jax_shift_cpsnr(jnp.clip(jnp.einsum("k,khw->hw", jnp.asarray(w),
                                                         jnp.asarray(st)), 0.0, 1.0),
                                     jnp.asarray(hr), jnp.asarray(hrm)))
               for st, hr, hrm in scene_data]
    return rows, w, stacked


def test_ensemble_rows_match_jax(data, weights):
    """ensemble_experiment with three members and --tta 8: every member,
    TTA member, full-stack, naive and registered pair and all-member score,
    the stacking weights and the stacked scores."""
    from highresnet_tpu_torch.eval.evaluator import Forward
    from highresnet_tpu_torch.examples.ensemble_experiment import (
        ensemble_rows,
        stack_weights,
        stacked_scores,
    )

    _, scenes = data
    params, models = weights
    best_val = {0: -10.0, 1: -12.0, 2: -11.0}  # seed 1 anchors
    fwds = {s: Forward.plain(m, CPU, host=False) for s, m in models.items()}
    ttas = {s: Forward.tta(m, CPU, transforms=8, host=False) for s, m in models.items()}
    rows, offsets, scene_data = ensemble_rows(fwds, ttas, best_val, scenes, L, "cpu")
    assert set(offsets) == {(0, 1), (0, 2), (1, 2)} and len(offsets[(0, 1)]) == 4
    want_rows, want_w, want_stacked = _jax_ensemble(params, best_val, scenes, 8)
    assert list(rows[0]) == list(want_rows[0])
    for key in rows[0]:
        if key != "scene":
            _close([r[key] for r in rows], [r[key] for r in want_rows], key)
    w = stack_weights(scene_data[0::2], "cpu")
    np.testing.assert_allclose(w, want_w, rtol=1e-3, atol=1e-4)
    _close(stacked_scores(w, scene_data, "cpu"), want_stacked, "stacked")


def test_precision_ablation_matches_jax(tmp_path):
    """The driver's protocol (production widths, 8 views of 16 px, batch 2)
    on JAX's PRNGKey(0) weights: f32 at f32 tolerance; bf16 and mixed
    statistics within 2x of JAX's; the same conclusion; the report schema of
    PRECISION_ABLATION.json."""
    from highresnet_tpu.config import DEFAULT_CONFIG
    from highresnet_tpu_torch.examples import precision_ablation as pa

    net = DEFAULT_CONFIG["network"]
    rng = np.random.default_rng(0)
    lrs = rng.random((2, 8, 16, 16)).astype(np.float32)
    alphas = np.ones((2, 8), np.float32)
    f32 = JaxHRNet(config=net, dtype=jnp.float32)
    params = jax.jit(f32.init)(jax.random.PRNGKey(0), jnp.asarray(lrs), jnp.asarray(alphas))["params"]

    def fwd(model, x):
        return np.asarray(jax.jit(lambda p, x, a: model.apply({"params": p}, x, a))(
            params, x, jnp.asarray(alphas)))

    x = jnp.asarray(lrs)
    want_out = {
        "f32": fwd(f32, x),
        "input_quant": fwd(f32, x.astype(jnp.bfloat16).astype(jnp.float32)),
        "mixed": fwd(JaxHRNet(config=net, dtype=jnp.bfloat16, decoder_dtype=jnp.float32), x),
        "bf16": fwd(JaxHRNet(config=net, dtype=jnp.bfloat16), x),
    }
    got_out = pa.run_variants(net, lrs, alphas, hrnet_state_dict_from_flax(params), "cpu")
    np.testing.assert_allclose(got_out["f32"], want_out["f32"], rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(got_out["input_quant"], want_out["input_quant"], rtol=1e-4,
                               atol=2e-5)
    got, want = pa.variant_rows(got_out), pa.variant_rows(want_out)
    for name in ("input_quant", "mixed", "bf16"):
        for key, value in want[name].items():
            assert value / 2 <= got[name][key] <= 2 * value, (name, key, got[name][key], value)
    assert pa.conclusion_flags(got) == pa.conclusion_flags(want)
    assert pa.conclusion_flags(got)["quantization_bound"]

    report = pa.main(["--device", "cpu", "--out", str(tmp_path / "p.json")])
    _same_schema(report, "PRECISION_ABLATION.json")
    assert set(report["variants"]) == set(want)


# --------------------------------------------------------------------------
# reports, outputs, devices


def _same_schema(report: dict, checked_in: str, protocol_superset: bool = False) -> None:
    """Top-level and protocol keys equal to a checked-in JAX report's (with
    ``protocol_superset``, the protocol holds at least the report's keys)."""
    ref = json.loads((REPO / checked_in).read_text())
    assert list(report) == list(ref), (checked_in, list(report), list(ref))
    if isinstance(ref.get("protocol"), dict):
        if protocol_superset:
            assert set(report["protocol"]) >= set(ref["protocol"]), checked_in
        else:
            assert list(report["protocol"]) == list(ref["protocol"]), checked_in


def test_tta_report_schema(data, weights, tmp_path, monkeypatch):
    """tta_experiment's main on a run dir and a fresh split: TTA_REPORT.json's
    keys, and its val rows equal to ``run_split``'s."""
    import shutil

    from highresnet_tpu_torch.examples import tta_experiment

    root, _ = data
    work = tmp_path / "tta"
    shutil.copytree(root, work)
    shutil.copytree(work / "train", work / "fresh" / "train")
    best = work / "ckpt" / "run" / "best"
    best.mkdir(parents=True)
    torch.save(weights[1][0].state_dict(), best / "HRNet.pth")
    import highresnet_tpu_torch.config as config_module

    real = config_module.load_config
    monkeypatch.setattr(config_module, "load_config",
                        lambda *a, **k: {**real(*a, **k), "network": NET})
    report = tta_experiment.main(["--root", str(work), "--views", str(L), "--batch", "1",
                                  "--fresh-dir", "fresh", "--device", "cpu",
                                  "--out", str(tmp_path / "t.json")])
    _same_schema(report, "TTA_REPORT.json")
    assert report["val_split"]["n_scenes"] == 1 and report["fresh_test"]["n_scenes"] == 4
    # the file's text, since paired_t is NaN on one val scene
    assert (tmp_path / "t.json").read_text() == json.dumps(report, indent=2)


def test_pipeline_bench_runs_and_keeps_the_schema(tmp_path):
    from highresnet_tpu_torch.examples import pipeline_bench

    report = pipeline_bench.main(["--root", str(tmp_path / "d"), "--scenes", "4", "--views", "4",
                                  "--lr-size", "32", "--patch", "16", "--batch", "2",
                                  "--epochs", "1", "--workers", "1",
                                  "--out", str(tmp_path / "p.json")])
    _same_schema(report, "PIPELINE_BENCH.json")
    assert report["protocol"]["scenes"] == 4 and report["protocol"]["host_cores"] >= 1
    assert all(report[k] > 0 for k in ("png_scenes_per_sec", "packed_scenes_per_sec",
                                        "cache_scenes_per_sec"))


RECIPE_ARGS = ["--baseline", "RECIPE_FT_CTL.json", "--candidate", "RECIPE_FT_RP30.json",
               "RECIPE_FT_RP100.json", "RECIPE_VARL_FT_FROM_RP.json",
               "--note", "first note", "--note", "second"]


def test_recipe_report_writes_the_jax_json(tmp_path, monkeypatch):
    """The same JSON as examples/recipe_report.py (a CPU subprocess) on the
    checked-in arms; RECIPE_REPORT.json's schema; a protocol mismatch refused."""
    from highresnet_tpu_torch.examples import recipe_report

    jax_out, port_out = tmp_path / "jax.json", tmp_path / "port.json"
    proc = subprocess.run([sys.executable, "examples/recipe_report.py", *RECIPE_ARGS,
                           "--out", str(jax_out)], cwd=REPO, capture_output=True, text=True,
                          timeout=120, env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    monkeypatch.chdir(REPO)
    report = recipe_report.main([*RECIPE_ARGS, "--out", str(port_out)])
    assert port_out.read_bytes() == jax_out.read_bytes()
    # RECIPE_REPORT.json's arms are not checked in and predate four protocol
    # keys; its protocol is the baseline's minus the recipe knobs
    _same_schema(report, "RECIPE_REPORT.json", protocol_superset=True)
    base = json.loads((REPO / "RECIPE_FT_CTL.json").read_text())["protocol"]
    assert list(report["protocol"]) == [k for k in base if k not in recipe_report.RECIPE_KEYS]
    with pytest.raises(SystemExit, match="protocols differ"):
        recipe_report.main(["--baseline", str(REPO / "RECIPE_FT_CTL.json"), "--candidate",
                            str(REPO / "RECIPE_EMA_BASE.json"), "--out",
                            str(tmp_path / "x.json")])


def _source(name: str) -> str:
    return (REPO / "highresnet_tpu_torch" / "examples" / f"{name}.py").read_text()


@pytest.mark.parametrize("name", DRIVERS)
def test_driver_defaults_write_no_tracked_file_and_run_on_the_card(name):
    """Each driver: its default --out lies under build/examples/ and names no
    file git tracks; a device driver defaults to cuda, calls setup_device,
    and without a card raises instead of falling back to the CPU."""
    import importlib

    from highresnet_tpu_torch.exp import harness

    src = _source(name)
    module = importlib.import_module(f"highresnet_tpu_torch.examples.{name}")
    outs = re.findall(r'"--out", default=default_out\("([A-Z_]+\.json)"\)', src)
    tracked = set(subprocess.run(["git", "ls-files"], cwd=REPO, capture_output=True,
                                 text=True).stdout.split())
    if name in ("quality_report", "test_model"):
        assert '"--out"' not in src  # they print; test_model's --submission has no default
    elif name == "display_dataset":
        assert '"--out", default="scene_previews"' in src and "scene_previews" not in tracked
    else:
        assert len(outs) == 1, name
        path = harness.default_out(outs[0])
        assert path == f"build/examples/{outs[0]}" and path not in tracked
    if name in HOST_ONLY:
        assert "setup_device" not in src and '"--device"' not in src
        return
    assert 'add_argument("--device", default="cuda")' in src and "setup_device(args.device)" in src
    if torch.cuda.is_available():
        return
    argv = {"quality_report": ["--data", "d", "--checkpoint", "c"],
            "test_model": ["--checkpoint", "c"]}.get(name, [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(argv)


def test_run_flagship_config_script_points_at_the_port():
    """The script is one call of the port's drive (its arc is held by
    test_torch_examples_config.py): no TPU supervisor, no JAX CLI, no
    settings of its own beyond the arguments it passes through."""
    sh = (REPO / "highresnet_tpu_torch" / "examples" / "run_flagship_config.sh").read_text()
    assert "supervise_tpu" not in sh and "highresnet_tpu.cli" not in sh
    assert not [word for word in sh.split() if word.startswith("/")]  # no absolute path
    code = [line for line in sh.splitlines() if line.strip() and not line.startswith("#")]
    assert code[-1] == ('exec python -m highresnet_tpu_torch.examples.flagship_config_report '
                        '--drive "$@"')
    assert "HRN_" not in sh and "build/examples/FLAGSHIP_CONFIG_DRIVE.json" in sh


def test_display_dataset_writes_previews(tmp_path):
    from highresnet_tpu_torch.examples import display_dataset

    paths = display_dataset.main(["--data", str(tmp_path / "d"), "--synthetic", "--out",
                                  str(tmp_path / "png"), "--n", "2"])
    assert len(paths) == 2
    for p in paths:
        assert Path(p).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_test_model_scores_the_splits_and_writes_a_submission(data, weights, tmp_path):
    """test_model: the ESA-ratio table over train and val (the scores are the
    evaluator's, held against JAX by test_torch_predict) and the zip."""
    from highresnet_tpu_torch.examples import test_model

    root, _ = data
    run = tmp_path / "run"
    run.mkdir()
    torch.save(weights[1][2].state_dict(), run / "HRNet.pth")
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({"paths": {"prefix": root}, "network": NET,
                               "training": {"min_L": L, "single_view_policy": "model"}}))
    table = test_model.main(["--config", str(cfg), "--checkpoint", str(run), "--device", "cpu",
                             "--submission", str(tmp_path / "sub")])
    assert sorted(table["part"].unique()) == ["train", "val"] and len(table) == 4
    assert np.isfinite(table["model"].astype(float)).all()
    assert (tmp_path / "sub" / "submission.zip").is_file()


# --------------------------------------------------------------------------
# H6: train_val_split without scikit-learn


@pytest.mark.parametrize("n", (12, 48, 60, 116, 300, 600, 1160))
@pytest.mark.parametrize("val", (0.1, 0.25))
def test_train_val_split_fallback_equals_sklearn(n, val, monkeypatch):
    """At the drivers' scene counts the seeded fallback (the GPU machine has
    no scikit-learn) assigns every scene as sklearn's train_test_split does,
    so held-out and fresh-test scenes on the card are the JAX reports' own."""
    from highresnet_tpu_torch.data import train_val_split

    dirs = [f"scene{i:04d}" for i in range(n)]
    with_sklearn = train_val_split(dirs, val, seed=1)
    real_import = builtins.__import__

    def no_sklearn(name, *args, **kwargs):
        if name.startswith("sklearn"):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_sklearn)
    fallback = train_val_split(dirs, val, seed=1)
    assert list(fallback) == list(with_sklearn)
    assert len(fallback[1]) == int(np.ceil(n * val))
