"""The port's serving extras against the JAX package on the same weights and
scenes: JAX's cubic resize and the single-view bicubic route, the dihedral
transforms, phase cross-correlation and PCC alignment, x4/x8 TTA and the
two-member ensemble, TTA's stacked forwards against the member-by-member
loop, and ShiftNet-registered scoring, on a port run dir and on a JAX run
dir exported by ``scripts/export_torch_weights.py``. Small sizes: a
one-residual-layer HRNet with 16 channels, 4 views of 16 px (SR 48 px),
ShiftNet at register size 32."""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from highresnet_tpu.data.probav import ImageSet as JaxImageSet
from highresnet_tpu.eval import evaluator as jax_evaluator
from highresnet_tpu.models import HRNet as JaxHRNet
from highresnet_tpu.models import ShiftNet as JaxShiftNet
from highresnet_tpu.models.convert import hrnet_params_from_torch, shiftnet_from_torch
from highresnet_tpu.ops import dihedral as jax_dihedral
from highresnet_tpu.ops.lanczos import lanczos_shift as jax_lanczos_shift
from highresnet_tpu.registration import search as jax_search
from highresnet_tpu_torch.data import (
    ImageSet,
    collate,
    discover_scenes,
    make_synthetic_dataset,
    read_imageset,
)
from highresnet_tpu_torch.eval import evaluator
from highresnet_tpu_torch.models import HRNet, ShiftNet, layers
from highresnet_tpu_torch.ops.dihedral import SAFE_SUBGROUP, dihedral_fwd, dihedral_inv
from highresnet_tpu_torch.ops.resize import resize_cubic
from highresnet_tpu_torch.registration.search import _pcc, pcc_align_batch
from highresnet_tpu_torch.train.checkpoint import CheckpointManager

PARITY_DB = 0.01
SR_RTOL, SR_ATOL = 1e-4, 2e-5
RESIZE_ATOL = 1e-6
UF = 100  # pcc_align_batch's upsample factor
NET = {
    "encoder": {"in_channels": 2, "num_layers": 1, "kernel_size": 3, "channel_size": 16},
    "recursive": {"alpha_residual": True, "in_channels": 16, "kernel_size": 3},
    "decoder": {
        "deconv": {"in_channels": 16, "kernel_size": 3, "stride": 3, "out_channels": 16},
        "final": {"in_channels": 16, "kernel_size": 1, "out_channels": 1},
    },
}
L, RS = 4, 32


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Four misaligned synthetic scenes, 4 views of 16 px, collated one by one."""
    root = make_synthetic_dataset(str(tmp_path_factory.mktemp("serving")), n_scenes_per_channel=2,
                                  n_views=L, lr_size=16, seed=11, hr_shift_sigma=1.25,
                                  splits=("train",))
    return [collate([read_imageset(d, top_k=L, beta=50.0)], L)
            for d in discover_scenes(f"{root}/train")]


def _hrnet(seed: int) -> HRNet:
    return HRNet(NET, generator=torch.Generator().manual_seed(seed)).eval()


def _jax_params(model: HRNet):
    return hrnet_params_from_torch(model.state_dict(), num_res_layers=1)


def _shiftnet(seed: int) -> ShiftNet:
    """Eval-mode ShiftNet with a random fc2 (it starts at zero) and BN
    statistics away from (0, 1), so the registered warp moves the SR."""
    model = ShiftNet(register_size=RS, generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        model.fc2.weight.copy_(torch.from_numpy(rng.normal(0, 0.05, (2, 1024)).astype(np.float32)))
        for i in range(1, 9):
            bn = getattr(model, f"layer{i}")[1]
            bn.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.1, bn.num_features)))
            bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, bn.num_features)))
    return model.eval()


def _score(sr: np.ndarray, batch) -> float:
    from highresnet_tpu_torch.ops.metrics import shift_cpsnr

    return float(shift_cpsnr(torch.from_numpy(sr).clamp(0, 1), torch.from_numpy(batch.hrs[0]),
                             torch.from_numpy(batch.hr_maps[0])))


# --- JAX's cubic resize (hazard H2) ------------------------------------------


@pytest.mark.parametrize("shape, size", [
    ((16, 16), (48, 48)), ((32, 32), (96, 96)), ((20, 28), (60, 84)), ((128, 128), (384, 384)),
])
def test_resize_cubic_matches_jax(shape, size, tmp_path):
    """On the route's input: LR views of synthetic scenes (crops of 128 px
    views), and a constant image, which must stay constant."""
    root = make_synthetic_dataset(str(tmp_path), n_scenes_per_channel=1, n_views=2, lr_size=128,
                                  seed=3, splits=("train",))
    for d in discover_scenes(f"{root}/train"):
        view = np.ascontiguousarray(read_imageset(d, top_k=2).lr[0][: shape[0], : shape[1]])
        want = np.asarray(jax.image.resize(jnp.asarray(view), size, method="cubic"))
        got = resize_cubic(torch.from_numpy(view), size).numpy()
        assert got.shape == size and np.abs(got - want).max() <= RESIZE_ATOL
    const = np.full(shape, 0.37, np.float32)
    got = resize_cubic(torch.from_numpy(const), size).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(const), size, method="cubic"))
    assert np.abs(got - 0.37).max() <= RESIZE_ATOL and np.abs(got - want).max() <= RESIZE_ATOL


def test_bicubic_route_matches_jax(scenes):
    """single_view_policy="bicubic" on a one-view scene: 3x cubic of the view,
    scored on the forward's device, against JAX's get_sr_and_score."""
    b = scenes[0]
    fields = dict(name=b.names[0], lr=b.lrs[0, :1], hr=b.hrs[0], hr_map=b.hr_maps[0])
    forward = evaluator.Forward.plain(_hrnet(0), torch.device("cpu"))
    sr, score = evaluator.get_sr_and_score(ImageSet(**fields), forward, min_l=L,
                                           single_view_policy="bicubic")
    want_sr, want_score = jax_evaluator.get_sr_and_score(JaxImageSet(**fields), None, min_l=L,
                                                         single_view_policy="bicubic")
    assert sr.shape == (48, 48)
    assert np.abs(sr - np.asarray(want_sr)).max() <= RESIZE_ATOL
    assert abs(score - want_score) <= PARITY_DB and np.isfinite(score)


# --- dihedral transforms ------------------------------------------------------


@pytest.mark.parametrize("t", range(8))
def test_dihedral_matches_jax(t):
    x = np.random.default_rng(t).random((2, 3, 5, 5), dtype=np.float32)
    fwd = dihedral_fwd(torch.from_numpy(x), t)
    assert np.array_equal(fwd.numpy(), np.asarray(jax_dihedral.dihedral_fwd(jnp.asarray(x), t)))
    assert np.array_equal(dihedral_inv(torch.from_numpy(x), t).numpy(),
                          np.asarray(jax_dihedral.dihedral_inv(jnp.asarray(x), t)))
    assert torch.equal(dihedral_inv(fwd, t), torch.from_numpy(x))
    if t in SAFE_SUBGROUP:
        rect = np.random.default_rng(t).random((2, 4, 6), dtype=np.float32)
        assert np.array_equal(dihedral_fwd(torch.from_numpy(rect), t).numpy(),
                              np.asarray(jax_dihedral.dihedral_fwd(jnp.asarray(rect), t)))
    with pytest.raises(ValueError, match="dihedral index"):
        dihedral_fwd(torch.from_numpy(x), t + 8)


# --- phase cross-correlation ---------------------------------------------------


def test_pcc_and_alignment_match_jax(scenes):
    """On Lanczos-shifted HR pairs: d within one zoom step (1/UF px) of JAX's;
    where d agrees exactly, the aligned images within 1e-5."""
    hrs = np.stack([b.hrs[0] for b in scenes]).astype(np.float32)
    shifts = np.random.default_rng(0).uniform(-2.5, 2.5, (len(hrs), 2)).astype(np.float32)
    mov = np.asarray(jax_lanczos_shift(jnp.asarray(hrs), jnp.asarray(shifts)))
    got_d = _pcc(torch.from_numpy(hrs), torch.from_numpy(mov), UF).numpy()
    for i in range(len(hrs)):
        want = np.asarray(jax_search._pcc(jnp.asarray(hrs[i]), jnp.asarray(mov[i]),
                                          upsample_factor=UF))
        assert np.abs(got_d[i] - want).max() <= 1 / UF + 1e-6, (i, got_d[i], want)
    aligned, d = pcc_align_batch(torch.from_numpy(hrs), torch.from_numpy(mov))
    want_aligned, want_d = map(np.asarray, jax_search.pcc_align_batch(jnp.asarray(hrs),
                                                                      jnp.asarray(mov)))
    assert np.abs(d.numpy() - want_d).max() <= 1 / UF + 1e-6
    assert np.abs(d.numpy() - shifts).max() < 0.3  # it finds the shift: mov(i) = ref(i + s)
    same = np.all(np.abs(d.numpy() - want_d) <= 1e-6, axis=1)
    assert same.any()
    np.testing.assert_allclose(aligned.numpy()[same], want_aligned[same], rtol=0, atol=1e-5)


# --- TTA and the registered ensemble -------------------------------------------


def _members_d(srs_port, srs_jax):
    """Each non-anchor member's PCC shift, port and JAX, on their own SRs."""
    anchor_p, anchor_j = srs_port[0], srs_jax[0]
    d_port = [pcc_align_batch(anchor_p, s)[1].numpy() for s in srs_port[1:]]
    d_jax = [np.asarray(jax_search.pcc_align_batch(anchor_j, s)[1]) for s in srs_jax[1:]]
    return np.stack(d_port), np.stack(d_jax)


@pytest.mark.parametrize("mode", ["tta4", "tta8", "ensemble"])
def test_tta_and_ensemble_match_jax(mode, scenes):
    models = [_hrnet(1), _hrnet(2)] if mode == "ensemble" else [_hrnet(1)]
    params = [_jax_params(m) for m in models]
    jax_net = JaxHRNet(config=NET)
    if mode == "ensemble":
        port = evaluator.Forward.ensemble(models, torch.device("cpu"))
        ref = jax_evaluator._EnsembleForward(jax_net, params)
    else:
        n = int(mode[3:])
        port = evaluator.Forward.tta(models[0], torch.device("cpu"), transforms=n)
        ref = jax_evaluator._TTAForward(jax_net, params[0], transforms=n)
    compared = 0
    for b in scenes:
        got, want = port(b.lrs, b.alphas)[0], ref(b.lrs, b.alphas)[0]
        assert abs(_score(got, b) - _score(np.asarray(want), b)) <= PARITY_DB, b.names
        # the members' SRs and their PCC shifts on each side
        x, a = torch.from_numpy(b.lrs), torch.from_numpy(b.alphas)
        with torch.no_grad():
            if mode == "ensemble":
                srs_p = [m(x, a) for m in models]
                srs_j = [jax_net.apply({"params": p}, b.lrs, b.alphas) for p in params]
            else:
                elements = [t for _, t in port.members]
                srs_p = [dihedral_inv(models[0](dihedral_fwd(x, t), a), t) for t in elements]
                srs_j = [jax_dihedral.dihedral_inv(jax_net.apply(
                    {"params": params[0]}, jax_dihedral.dihedral_fwd(jnp.asarray(b.lrs), t),
                    b.alphas), t) for t in elements]
        d_port, d_jax = _members_d(srs_p, srs_j)
        if np.abs(d_port - d_jax).max() <= 1e-6:
            np.testing.assert_allclose(got, np.asarray(want), rtol=SR_RTOL, atol=SR_ATOL)
            compared += 1
    assert compared >= len(scenes) // 2, compared


def test_tta_guards():
    model = _hrnet(0)
    with pytest.raises(ValueError, match="transforms"):
        evaluator.Forward.tta(model, torch.device("cpu"), transforms=3)
    tta = evaluator.Forward.tta(model, torch.device("cpu"), transforms=8)
    with pytest.raises(ValueError, match="square"):
        tta(np.zeros((1, L, 16, 12), np.float32), np.ones((1, L), np.float32))
    out = evaluator.Forward.tta(model, torch.device("cpu"), transforms=4)(
        np.random.default_rng(0).random((1, L, 16, 12), dtype=np.float32), np.ones((1, L), np.float32))
    assert out.shape == (1, 48, 36) and np.isfinite(out).all()


# --- stacked members ------------------------------------------------------------

STACK_ATOL = 1e-5
# transforms, (B, H, W) of the LR stack, the batch sizes of the model calls
STACK_CASES = {
    "x8-square-b1": (8, (1, 16, 16), [8]),
    "x4-nonsquare-b1": (4, (1, 16, 12), [4]),
    "x8-b2": (8, (2, 16, 16), [8, 8]),
    "x8-b8": (8, (8, 16, 16), [8] * 8),
}


def _batch_sizes(model):
    """The batch size of every call of ``model``, as it is called."""
    seen = []
    model.register_forward_hook(lambda _, args, out: seen.append(args[0].shape[0]))
    return seen


def _member_loop(fwd, lrs, alphas):
    """The oracle: each member a forward of its own, one after another, each
    SR PCC-aligned to the first member's with ``register``, then the mean."""
    x, a = torch.from_numpy(lrs), torch.from_numpy(alphas)
    with torch.inference_mode():
        srs = [m(x, a) if t is None else dihedral_inv(m(dihedral_fwd(x, t), a), t)
               for m, t in fwd.members]
        if fwd.register:
            aligned, _ = pcc_align_batch(srs[0].repeat(len(srs) - 1, 1, 1), torch.cat(srs[1:]))
            srs = [srs[0], *aligned.split(x.shape[0])]
        return torch.stack(srs).mean(dim=0).numpy()


@pytest.mark.parametrize("register", [True, False], ids=["register", "raw"])
@pytest.mark.parametrize("case", STACK_CASES)
def test_stacked_tta_equals_member_loop(case, register):
    transforms, (b, h, w), calls = STACK_CASES[case]
    model = _hrnet(5)
    fwd = evaluator.Forward.tta(model, torch.device("cpu"), transforms=transforms,
                                register=register)
    rng = np.random.default_rng(7)
    lrs = rng.random((b, L, h, w), dtype=np.float32)
    alphas = np.ones((b, L), np.float32)
    alphas[0, -1] = 0.0  # a padded view in the first scene alone: alphas follow their scene
    seen = _batch_sizes(model)
    got = fwd(lrs, alphas)
    assert seen == calls
    np.testing.assert_allclose(got, _member_loop(fwd, lrs, alphas), rtol=0, atol=STACK_ATOL)


@pytest.mark.parametrize("kind", ["conv", "deconv"])
@pytest.mark.parametrize("members,size,calls", [
    (1, 3, [3]),            # no stack: one call
    (4, 3, [3, 3, 3, 3]),   # under 8 samples a member: once a member
    (4, 8, [32]),           # 8 a member: one call over the stack
    (2, 16, [32]),
])
def test_stacked_members_run_small_convs_once_a_member(kind, members, size, calls, monkeypatch):
    torch.manual_seed(0)
    if kind == "conv":
        conv, name = layers.Conv2d(3, 5, 3, padding=1), "conv2d"
    else:
        conv, name = layers.ConvTranspose2d(3, 5, 3, stride=3), "conv_transpose2d"
    x = torch.randn(members * size, 3, 6, 6)
    with torch.inference_mode():
        want = conv(x)
        seen, real = [], getattr(torch.nn.functional, name)
        monkeypatch.setattr(torch.nn.functional, name,
                            lambda inp, *args: seen.append(inp.shape[0]) or real(inp, *args))
        with layers.stacked_members(members):
            got = conv(x)
        assert seen == calls
        conv(x)  # the context is left: one call again
    assert seen == calls + [members * size]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_ensemble_runs_each_member_alone():
    models = [_hrnet(1), _hrnet(2)]
    fwd = evaluator.Forward.ensemble(models, torch.device("cpu"))
    lrs = np.random.default_rng(8).random((2, L, 16, 16), dtype=np.float32)
    alphas = np.ones((2, L), np.float32)
    seen = [_batch_sizes(m) for m in models]
    got = fwd(lrs, alphas)
    assert seen == [[2], [2]]
    np.testing.assert_allclose(got, _member_loop(fwd, lrs, alphas), rtol=0, atol=STACK_ATOL)


# --- ShiftNet-registered scoring ------------------------------------------------


@pytest.fixture(scope="module")
def joint_run(tmp_path_factory):
    """A port run dir whose best/ holds HRNet.pth and ShiftNet.pth."""
    run_dir = str(tmp_path_factory.mktemp("joint") / "run")
    hrnet, shiftnet = _hrnet(3), _shiftnet(4)
    stats = {k: v for k, v in shiftnet.state_dict().items() if "running" in k or "num_batches" in k}
    params = {k: v for k, v in shiftnet.state_dict().items() if k not in stats}
    CheckpointManager(run_dir).save_best({"hrnet": hrnet.state_dict(), "shiftnet": params}, stats,
                                         score=-1.0)
    return run_dir, hrnet, shiftnet


def _config(**training):
    return {"network": NET, "paths": {"prefix": ""},
            "training": {"min_L": L, "register_size": RS, "single_view_policy": "model",
                         **training}}


def test_registered_scoring_matches_jax(scenes, joint_run):
    run_dir, hrnet, shiftnet = joint_run
    model = evaluator.Model(_config(), device="cpu")
    model.load_checkpoint_with_shiftnet(run_dir)
    assert not model.registration.training
    sn_params, sn_stats = shiftnet_from_torch(shiftnet.state_dict())
    registration = (JaxShiftNet(), {"params": sn_params, "batch_stats": sn_stats})
    forward = jax_evaluator._JittedForward(JaxHRNet(config=NET), _jax_params(hrnet))
    moved = 0.0
    for b in scenes:
        sr, score = model(b, registered=True)
        _, plain = model(b)
        want_sr, want = jax_evaluator.get_sr_and_score(b, forward, min_l=L,
                                                       registration=registration,
                                                       register_size=RS)
        np.testing.assert_allclose(sr, np.asarray(want_sr), rtol=SR_RTOL, atol=SR_ATOL)
        assert abs(score - want) <= PARITY_DB, (b.names, score, want)
        moved = max(moved, abs(score - plain))
    assert moved > 1e-4  # the registered warp changed a score
    with pytest.raises(ValueError, match="registered eval needs SR"):
        evaluator.get_sr_and_score(scenes[0], model.forward, min_l=L,
                                   registration=model.registration, register_size=64)


def test_load_checkpoint_with_shiftnet_honours_compute_dtype(joint_run, tmp_path):
    """H5: the JAX loader builds HRNet at f32 whatever compute_dtype says."""
    run_dir, _, _ = joint_run
    model = evaluator.Model(_config(compute_dtype="bfloat16"), device="cpu")
    model.load_checkpoint_with_shiftnet(run_dir)
    assert model.hrnet.dtype == torch.bfloat16 and model.hrnet.decoder_dtype == torch.bfloat16
    assert next(model.registration.parameters()).dtype == torch.float32
    with pytest.raises(ValueError, match="load_checkpoint_with_shiftnet"):
        evaluator.Model(_config(), device="cpu")(None, registered=True)
    with pytest.raises(FileNotFoundError, match="ShiftNet.pth"):
        model.load_checkpoint_with_shiftnet(str(tmp_path))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX run dir whose Orbax best/ holds flax-drawn HRNet and ShiftNet
    weights (a random fc2 and BN statistics away from (0, 1), so the
    registered warp moves the SR), saved by the JAX package's
    CheckpointManager, and its config file."""
    from highresnet_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager

    tmp = tmp_path_factory.mktemp("jax_run")
    rng = np.random.default_rng(9)
    hrnet = JaxHRNet(config=NET).init(jax.random.PRNGKey(5), jnp.zeros((1, L, 16, 16)),
                                      jnp.ones((1, L)))["params"]
    variables = JaxShiftNet().init(jax.random.PRNGKey(6), jnp.zeros((1, RS, RS, 2)), train=False)
    shiftnet = jax.device_get(variables["params"])
    shiftnet["fc2"]["kernel"] = rng.normal(0, 0.05, (1024, 2)).astype(np.float32)
    stats = {name: {"mean": rng.normal(0, 0.1, s["mean"].shape).astype(np.float32),
                    "var": rng.uniform(0.5, 2.0, s["var"].shape).astype(np.float32)}
             for name, s in variables["batch_stats"].items()}
    run_dir = str(tmp / "run")
    ckpt = JaxCheckpointManager(run_dir)
    ckpt.save_best({"hrnet": hrnet, "shiftnet": shiftnet}, stats, score=-1.0)
    ckpt.wait()
    config = tmp / "config.json"
    config.write_text(json.dumps(_config()))
    return str(config), run_dir


def _export(config: str, run_dir: str) -> str:
    spec = importlib.util.spec_from_file_location(
        "export_torch_weights", Path(__file__).resolve().parents[1] / "scripts"
        / "export_torch_weights.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main(["--config", config, "--run-dir", run_dir])


def test_exported_jax_run_scores_registered_as_jax(scenes, jax_run):
    """scripts/export_torch_weights.py writes HRNet.pth and ShiftNet.pth to
    the run dir's best/; the port's registered scoring on the exported
    run agrees with JAX's on its Orbax checkpoint within 0.01 dB a scene."""
    from highresnet_tpu.config import load_config as jax_load_config

    config, run_dir = jax_run
    assert _export(config, run_dir) == str(Path(run_dir) / "best" / "HRNet.pth")
    assert {"HRNet.pth", "ShiftNet.pth"} <= {p.name for p in (Path(run_dir) / "best").iterdir()}
    model = evaluator.Model(_config(), device="cpu")
    model.load_checkpoint_with_shiftnet(run_dir)
    jax_model = jax_evaluator.Model(jax_load_config(config))
    jax_model.load_checkpoint_with_shiftnet(run_dir)
    moved = 0.0
    for b in scenes:
        _, score = model(b, registered=True)
        _, plain = model(b)
        _, want = jax_evaluator.get_sr_and_score(b, jax_model.forward, min_l=L,
                                                 registration=jax_model.registration,
                                                 register_size=RS)
        assert abs(score - want) <= PARITY_DB, (b.names, score, want)
        moved = max(moved, abs(score - plain))
    assert moved > 1e-4  # the registered warp changed a score
