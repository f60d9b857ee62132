"""TR-MISR (``models/trmisr.py``, ``network.arch: "trmisr"``) on the port's paths.

On the CPU, at a small size (batch 2, L 5 with 3 real views, 16 px, dim 16,
2 heads of 8, depth 2), against the plain reference
``perfbench/reference/trmisr.py`` on seeded weights: the forward; that a
padded view's contents and the order of the real views do not move the SR;
the registered step's loss and every gradient (dropout off) against the
reference's registered step; that the dropout masks come from the state's
generator; the network seam; serving through ``Model`` (plain, x8 TTA, an
ensemble, ShiftNet-registered scoring) and ``cli.train`` -> checkpoint ->
``cli.predict``. On a card (skipped without one): the attention kernel
against its plain version, and replayed steps against eager steps bit for
bit, dropout included.

This file imports neither JAX nor the JAX package, so it runs on a GPU
machine without JAX:

    python -m pytest tests/test_torch_trmisr.py --noconftest -q
"""

import json
import math
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from highresnet_tpu_torch.config import load_config, network_arch
from highresnet_tpu_torch.eval.evaluator import Model
from highresnet_tpu_torch.models.hrnet import HRNet
from highresnet_tpu_torch.models.network import (best_files, build_network, weights_file,
                                                 with_shiftnet)
from highresnet_tpu_torch.models.rams import RAMS
from highresnet_tpu_torch.models.trmisr import TRNet
from highresnet_tpu_torch.ops import attention
from highresnet_tpu_torch.ops.dihedral import dihedral_fwd, dihedral_inv
from highresnet_tpu_torch.train import graphs
from highresnet_tpu_torch.train import step as step_module
from highresnet_tpu_torch.train.state import create_train_state
from highresnet_tpu_torch.train.step import build_train_step
from perfbench import compare, synth, weights
from perfbench.reference import shiftnet as ref_shiftnet
from perfbench.reference import trmisr as ref_trmisr
from perfbench.reference.train import Trainer

ROOT = Path(__file__).resolve().parents[1]
TINY = {"encoder": {"in_channels": 2, "num_layers": 2, "kernel_size": 3, "channel_size": 16},
        "transformer": {"dim": 16, "depth": 2, "heads": 2, "head_dim": 8, "mlp_dim": 32}}
FORWARD_RTOL = 1e-5  # max |SR - ref| / max |ref|: the same f32 products, summed in other orders
GRAD_TOL = 1e-4  # max |Δg| per tensor over its norm: f32 round-off through the backward
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs files side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def tiny_network() -> dict:
    config = load_config(str(ROOT / "configs" / "trmisr.json"))["network"]
    return {**config, "encoder": dict(TINY["encoder"]),
            "transformer": {**config["transformer"], **TINY["transformer"]}}


def trmisr_config(**training) -> dict:
    """``configs/trmisr.json`` at the small widths: batch 2, L 5, 16 px
    patches, ShiftNet at 32, no warm-ups."""
    config = load_config(str(ROOT / "configs" / "trmisr.json"))
    config["network"] = tiny_network()
    config["training"].update(batch_size=2, min_L=5, n_views=5, patch_size=16,
                              register_size=32, shiftnet_warmup_steps=0,
                              register_warmup_epochs=0, **training)
    return config


def ref_weights(network, seed: int, device="cpu") -> dict:
    g = torch.Generator(device=device).manual_seed(seed)
    return weights.make(ref_trmisr.param_spec(network), g, device)


def scenes(n: int, views: int, size: int, seed: int, real=None, device="cpu"):
    """(lrs, alphas, hrs, hr_maps) of ``n`` scenes of ``views`` views,
    ``real`` of them real (all by default)."""
    g = torch.Generator(device=device).manual_seed(seed)
    lrs, alphas, hrs, maps = synth.scenes(g, n, views, size, device, min_views=views)
    if real is not None:
        alphas[:, real:] = 0
        lrs[:, real:] = 0
    return lrs, alphas, hrs, maps


def loaded(network, params) -> TRNet:
    model = TRNet(network)
    model.load_state_dict(params)
    return model.eval()


# -- the network (CPU) ---------------------------------------------------------


def test_forward_matches_the_reference():
    net = tiny_network()
    params = ref_weights(net, 1)
    lrs, alphas, _, _ = scenes(2, 5, 16, 2, real=3)
    alphas[1, 3] = 1.0  # the second scene has a fourth real view
    lrs[1, 3] = lrs[1, 0].flip(0)
    with torch.no_grad():
        got = loaded(net, params)(lrs, alphas)
        want = ref_trmisr.TRMISR(net)(params, lrs, alphas)
        one_by_one = ref_trmisr.TRMISR(net)(params, lrs, alphas, scenes_per_call=1)
    assert got.shape == (2, 48, 48)
    assert compare.image_gap(got.numpy(), want.numpy()) < FORWARD_RTOL
    assert torch.equal(one_by_one, want)


def test_published_widths():
    """1,079,055 parameters at the published widths, as ``configs/trmisr.json``
    and the benchmark's copy give them."""
    config = load_config(str(ROOT / "configs" / "trmisr.json"))
    assert sum(p.numel() for p in TRNet({}).parameters()) == 1_079_055
    model = build_network(config, "cpu")
    assert sum(p.numel() for p in model.parameters()) == 1_079_055
    spec = ref_trmisr.param_spec(config["network"])
    assert {k: s for k, s, _, _ in spec} == {k: tuple(v.shape)
                                             for k, v in model.state_dict().items()}
    bench = json.loads((ROOT / "perfbench" / "configs" / "trmisr-probav.json").read_text())
    assert bench == json.loads((ROOT / "configs" / "trmisr.json").read_text())


def test_padded_views_do_not_move_the_sr():
    """A padded view (alpha 0) is a masked key: its contents reach neither the
    fusion's output nor, past the first nine views that the anchor reads,
    the SR."""
    net = tiny_network()
    model = loaded(net, ref_weights(net, 3))
    lrs, alphas, _, _ = scenes(2, 11, 8, 4, real=9)
    noisy = lrs.clone()
    noisy[:, 9:] = torch.rand(2, 2, 8, 8, generator=torch.Generator().manual_seed(5))
    states = torch.randn(2, 5, 16, 4, 4, generator=torch.Generator().manual_seed(6))
    a = torch.tensor([[1.0, 1, 1, 0, 0], [1, 0, 1, 1, 0]])
    moved = states.clone()
    moved[a == 0] = torch.randn(4, 16, 4, 4, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        assert torch.equal(model(noisy, alphas), model(lrs, alphas))
        assert torch.equal(model.fuse(moved, a, 0.0, None), model.fuse(states, a, 0.0, None))


def test_permuting_the_real_views_leaves_the_sr():
    net = tiny_network()
    model = loaded(net, ref_weights(net, 8))
    lrs, alphas, _, _ = scenes(2, 5, 16, 9, real=3)
    order = torch.tensor([2, 0, 1, 3, 4])
    with torch.no_grad():
        base = model(lrs, alphas)
        permuted = model(lrs[:, order], alphas[:, order])
    assert compare.image_gap(permuted.numpy(), base.numpy()) < 1e-6


def test_attention_twin_is_the_per_head_softmax():
    """``attend_ref`` against a loop over heads with the masked keys filled."""
    g = torch.Generator().manual_seed(10)
    qkv = torch.randn(2, 3, 6, 3 * 2 * 4, generator=g)
    ok = torch.tensor([[1, 1, 1, 0, 0, 1], [1, 0, 1, 1, 1, 0]], dtype=torch.bool)
    bias = torch.zeros(2, 6).masked_fill(~ok, -math.inf)
    got = attention.attend_ref(qkv, bias, 2)
    assert torch.equal(attention.attend(qkv, bias, 2), got)  # the CPU takes the plain version
    want = torch.empty(2, 3, 6, 8)
    for h in range(2):
        q, k, v = (qkv[..., (j * 2 + h) * 4:(j * 2 + h + 1) * 4] for j in range(3))
        s = (q @ k.transpose(-1, -2) / 2.0).masked_fill(~ok[:, None, None, :], -math.inf)
        want[..., h * 4:(h + 1) * 4] = torch.softmax(s, dim=-1) @ v
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


# -- training (CPU) ---------------------------------------------------------------


def joint_params(config, seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    register = config["training"]["register_size"]
    return {**weights.make(ref_trmisr.param_spec(config["network"]), g, "cpu", "hrnet."),
            **weights.make(ref_shiftnet.param_spec(register), g, "cpu", "shiftnet.")}


def loaded_state(config, params, dropout_seed: int):
    state = create_train_state(config, "cpu", torch.Generator().manual_seed(0))
    for prefix, model in (("hrnet.", state.hrnet), ("shiftnet.", state.shiftnet)):
        n = len(prefix)
        model.load_state_dict({k[n:]: v for k, v in params.items() if k.startswith(prefix)},
                              strict=False)
    state.generator = torch.Generator().manual_seed(dropout_seed)
    return state


def test_registered_step_matches_the_reference():
    """One ``build_train_step`` step (TR-MISR's dropout off; ShiftNet's mask
    from the same seed on both sides): its loss, and every parameter's
    gradient against the reference's registered loss with TR-MISR in
    HRNet's place."""
    config = trmisr_config()
    params = joint_params(config, 11)
    state = loaded_state(config, params, 12)
    state.hrnet.dropout = 0.0
    trainer = Trainer(config, params, 12)
    trainer.hrnet = ref_trmisr.TRMISR(config["network"])
    batch = scenes(2, 5, 16, 13, real=4)
    loss = trainer.loss(*batch)
    keys = list(trainer.params)
    ref_grads = dict(zip(keys, torch.autograd.grad(loss, [trainer.params[k] for k in keys])))
    state, m = build_train_step(config)(state, *batch)
    torch.testing.assert_close(m["loss"], loss.detach(), rtol=LOSS_RTOL, atol=0)
    got = {f"{name}.{k}": p.grad for name, model in state.models.items()
           for k, p in model.named_parameters()}
    assert set(got) == set(ref_grads)
    for k, g in ref_grads.items():
        gap = (got[k] - g).abs().max() / max(g.norm(), 1e-30)
        assert gap < GRAD_TOL, (k, gap.item())
    assert ref_grads["hrnet.fuse.token"].norm() > 0  # the token's gradient reaches it


def test_dropout_draws_from_the_states_generator():
    config = trmisr_config()
    params = joint_params(config, 14)
    batch = scenes(2, 5, 16, 15)
    runs = []
    for global_seed in (1, 2):
        torch.manual_seed(global_seed)  # the global RNG plays no part
        state = loaded_state(config, params, 16)
        state, m = build_train_step(config)(state, *batch)
        runs.append((m["loss"], state.hrnet.state_dict(), state.generator.get_state()))
    (loss_a, sd_a, gen_a), (loss_b, sd_b, gen_b) = runs
    assert torch.equal(loss_a, loss_b) and torch.equal(gen_a, gen_b)
    assert all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a)
    quiet = loaded_state(config, params, 16)
    quiet.hrnet.dropout = 0.0
    _, m = build_train_step(config)(quiet, *batch)
    assert not torch.equal(m["loss"], loss_a)  # the masks acted
    model = loaded(config["network"], {k[6:]: v for k, v in params.items()
                                       if k.startswith("hrnet.")}).train()
    with pytest.raises(ValueError, match="generator"):
        model(*batch[:2])


def test_the_network_seam_reads_trmisr():
    config = load_config(str(ROOT / "configs" / "trmisr.json"))
    assert network_arch(config) == "trmisr"
    assert isinstance(build_network(config, "cpu"), TRNet)
    assert weights_file(config) == "TRNet.pth"
    assert with_shiftnet(config)
    assert best_files(config) == ("TRNet.pth", "ShiftNet.pth")
    with pytest.raises(ValueError, match="float32"):
        build_network(trmisr_config(compute_dtype="bfloat16"), "cpu")
    with pytest.raises(ValueError, match="channel_size"):
        TRNet({"transformer": {"dim": 32}})
    with pytest.raises(ValueError, match="view axis"):
        TRNet(tiny_network()).shard_views(object())
    state = create_train_state(trmisr_config(), "cpu", torch.Generator().manual_seed(0))
    held = {id(p) for group in state.optimizer.param_groups for p in group["params"]}
    assert held == {id(p) for m in (state.hrnet, state.shiftnet) for p in m.parameters()}


def test_every_existing_configuration_builds_what_it_built():
    paths = [*(ROOT / "configs").glob("*.json"), *(ROOT / "perfbench" / "configs").glob("*.json")]
    want = {"rams": RAMS, "trmisr": TRNet}
    for path in paths:
        config = load_config(str(path))
        cls = want.get(path.stem.split("-")[0].split("_")[0], HRNet)
        assert isinstance(build_network(config, "cpu"), cls), path
        assert with_shiftnet(config) == (cls is not RAMS), path


# -- serving and the CLIs (CPU) --------------------------------------------------


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """One cli.train epoch of the small TR-MISR on synthetic scenes."""
    from highresnet_tpu_torch.cli.train import main as train_main
    from highresnet_tpu_torch.data.synth import make_synthetic_dataset

    tmp = tmp_path_factory.mktemp("trmisr")
    data = make_synthetic_dataset(str(tmp / "data"), n_scenes_per_channel=3, n_views=5,
                                  lr_size=16, seed=3)
    config = trmisr_config(num_epochs=1, n_workers=1, seed=0, eval_batch_size=2,
                           val_proportion=0.34, augment_dihedral=False)
    config["paths"] = {"prefix": data, "checkpoint_dir": str(tmp / "ckpt"),
                       "tb_log_file_dir": ""}
    path = tmp / "trmisr.json"
    path.write_text(json.dumps(config))
    run_dir = str(tmp / "run")
    out = train_main(["--config", str(path), "--run-dir", run_dir, "--device", "cpu"])
    return {"config": str(path), "run_dir": run_dir, "out": out, "data": data}


def test_cli_train_checkpoints_trmisr_with_shiftnet(cli_run):
    from highresnet_tpu_torch.train.checkpoint import CheckpointManager

    run_dir = cli_run["run_dir"]
    assert sorted(os.listdir(os.path.join(run_dir, "best"))) == ["ShiftNet.pth", "TRNet.pth"]
    assert np.isfinite(cli_run["out"]["best_score"])
    with open(os.path.join(run_dir, "latest.json")) as f:
        slot = json.load(f)["slot"]
    saved = torch.load(os.path.join(run_dir, slot, "state.pt"), weights_only=True)
    assert saved["shiftnet"] is not None and saved["step"] > 0
    config = load_config(cli_run["config"])
    best = CheckpointManager.for_config(run_dir, config).load_best()
    assert set(best["params"]) == {"hrnet", "shiftnet"}
    state = create_train_state(config, "cpu", torch.Generator().manual_seed(9))
    state.load_state_dict(saved)
    for k, p in state.hrnet.state_dict().items():
        assert torch.equal(p, saved["hrnet"][k])
    loaded(config["network"], best["params"]["hrnet"])


def test_cli_predict_serves_the_run(cli_run):
    from highresnet_tpu_torch.cli.predict import main as predict_main

    for extra in ([], ["--tta", "8"], ["--registered"]):
        table = predict_main(["--config", cli_run["config"], "--checkpoint", cli_run["run_dir"],
                              "--splits", "train", "val", "--device", "cpu", *extra])
        assert len(table) == 6 and np.isfinite(table["model"].astype(float)).all(), extra


def test_model_serves_trmisr_plain(cli_run):
    config = load_config(cli_run["config"])
    params = ref_weights(config["network"], 17)
    lrs, alphas, _, _ = scenes(2, 5, 16, 18, real=4)
    model = Model(config, "cpu")
    model.set_params(params)
    got = model.forward(lrs.numpy(), alphas.numpy())
    with torch.no_grad():
        want = ref_trmisr.TRMISR(config["network"])(params, lrs, alphas).numpy()
    assert compare.image_gap(got, want) < FORWARD_RTOL
    served = Model(config, "cpu")
    served.load_checkpoint(cli_run["run_dir"])  # a run directory: best/TRNet.pth
    assert isinstance(served.hrnet, TRNet)


def test_model_serves_trmisr_under_x8_tta(cli_run):
    """Unregistered x8 TTA is the mean of the eight dihedral members."""
    config = load_config(cli_run["config"])
    model = Model(config, "cpu")
    model.load_checkpoint(cli_run["run_dir"])
    lrs, alphas, _, _ = scenes(1, 5, 16, 19, real=4)
    model.enable_tta(8, register=False)
    got = model.forward(lrs.numpy(), alphas.numpy())
    with torch.no_grad():
        want = torch.stack([dihedral_inv(model.hrnet(dihedral_fwd(lrs, t), alphas), t)
                            for t in range(8)]).mean(dim=0)
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-6)


def test_model_serves_a_trmisr_ensemble(cli_run):
    config = load_config(cli_run["config"])
    single = Model(config, "cpu")
    single.load_checkpoint(cli_run["run_dir"])
    pair = Model(config, "cpu")
    pair.load_ensemble([cli_run["run_dir"]] * 2, register=False)
    lrs, alphas, _, _ = scenes(2, 5, 16, 20, real=4)
    assert len(pair.forward.members) == 2
    np.testing.assert_allclose(pair.forward(lrs.numpy(), alphas.numpy()),
                               single.forward(lrs.numpy(), alphas.numpy()), rtol=0, atol=1e-7)


def test_model_scores_trmisr_registered_by_shiftnet(cli_run):
    from highresnet_tpu_torch.data import SceneDataset, discover_scenes

    config = load_config(cli_run["config"])
    model = Model(config, "cpu")
    model.load_checkpoint_with_shiftnet(cli_run["run_dir"])
    assert isinstance(model.hrnet, TRNet) and model.registration is not None
    imset = SceneDataset(discover_scenes(os.path.join(cli_run["data"], "train")),
                         create_patches=False)[0]
    sr, score = model(imset, registered=True)
    plain_sr, plain_score = model(imset)
    assert np.array_equal(sr, plain_sr) and np.isfinite(score) and np.isfinite(plain_score)


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from highresnet_tpu_torch.runtime import setup_device

    return setup_device("cuda")


@pytest.mark.cuda
def test_attention_kernel_matches_its_plain_version(cuda):
    """K5 at the cell's head shape (8 heads of 64, 17 tokens),
    forward against ``attend_ref``, and the backward through ``Attend``
    against the plain version's gradient."""
    g = torch.Generator(device=cuda).manual_seed(21)
    qkv = torch.randn(3, 700, 17, 3 * 8 * 64, generator=g, device=cuda)
    ok = torch.rand(3, 17, generator=g, device=cuda) < 0.7
    ok[:, 0] = True
    bias = torch.zeros(3, 17, device=cuda).masked_fill(~ok, -math.inf)
    before = attention.LAUNCHES
    got = attention.attend(qkv, bias, 8)
    want = attention.attend_ref(qkv, bias, 8)
    assert attention.LAUNCHES == before + 1
    assert ((got - want).abs().max() / want.abs().max()).item() < 1e-6
    x = qkv.clone().requires_grad_()
    cot = torch.randn(got.shape, generator=g, device=cuda)
    (ga,) = torch.autograd.grad(attention.attend(x, bias, 8), x, cot)
    (gb,) = torch.autograd.grad(attention.attend_ref(x, bias, 8), x, cot)
    assert torch.equal(ga, gb)  # the backward recomputes the plain version


def run_steps(config, batches, device, graphed: bool, monkeypatch):
    """A fresh state and step through ``batches`` (sizes of scenes), with
    graphs or eagerly: the state, each step's metrics, the captures and replays."""
    counts = {"capture": 0, "replay": 0}
    capture, replay = graphs.capture, graphs.StepGraphs.replay

    def counted_capture(*a, **k):
        counts["capture"] += 1
        return capture(*a, **k)

    def counted_replay(self, batch):
        counts["replay"] += 1
        return replay(self, batch)

    with monkeypatch.context() as m:
        m.setattr(graphs, "capture", counted_capture)
        m.setattr(graphs.StepGraphs, "replay", counted_replay)
        if not graphed:
            m.setattr(step_module, "eligible", lambda device, synced: False)
        state = create_train_state(config, device, torch.Generator().manual_seed(0))
        step = build_train_step(config)
        metrics = []
        for i, n in enumerate(batches):
            if i == 4:
                state = state.with_learning_rate(state.learning_rate / 4)
            batch = scenes(n, 5, config["training"]["patch_size"], 100 + i,
                           real=4 if i % 2 else None, device=device)
            state, out = step(state, *batch)
            metrics.append(out)
    return state, metrics, counts


@pytest.mark.cuda
def test_replayed_trmisr_steps_equal_eager_steps_bit_for_bit(cuda, monkeypatch):
    config = trmisr_config(ema_decay=0.99, grad_clip_norm=0.05)
    assert config["network"]["transformer"]["dropout"] == 0.1  # the masks are drawn
    sizes = [4, 4, 4, 2, 2, 2, 4, 4]  # a shape change after step 3 and back; the lr falls at 4
    launches = attention.LAUNCHES
    eager, eager_m, eager_n = run_steps(config, sizes, cuda, False, monkeypatch)
    launches, eager_launches = attention.LAUNCHES, attention.LAUNCHES - launches
    replayed, replayed_m, n = run_steps(config, sizes, cuda, True, monkeypatch)
    assert eager_n == {"capture": 0, "replay": 0}
    assert n == {"capture": 2, "replay": len(sizes) - 2}
    # K5 once a block a step; a replay adds the launches its capture counted
    assert attention.LAUNCHES - launches == eager_launches == len(sizes) * 2
    for g, w in zip(replayed_m, eager_m):
        for k in ("loss", "mean_abs_shift", "max_abs_shift", "grad_norm"):
            assert torch.equal(g[k], w[k]), k
    for name in ("hrnet", "shiftnet"):
        want, got = eager.models[name].state_dict(), replayed.models[name].state_dict()
        for k, p in want.items():
            assert torch.equal(got[k], p), (name, k)
        for k, t in eager.ema[name].items():
            assert torch.equal(replayed.ema[name][k], t), (name, k)
    for p, q in zip(eager.optimizer.param_groups[0]["params"],
                    replayed.optimizer.param_groups[0]["params"]):
        sa, sb = eager.optimizer.state[p], replayed.optimizer.state[q]
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert torch.equal(replayed.generator.get_state(), eager.generator.get_state())
    assert replayed.step == eager.step == len(sizes)
