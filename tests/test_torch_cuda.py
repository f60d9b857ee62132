"""The port's tests that need an NVIDIA GPU: its four CUDA kernels against
their plain versions, the profiler's view of their wrappers (no NaN fill of
the output, one kernel for the warp's forward), x8 TTA's stacked forward
against its members run one at a time, and a GPU training run that
repeats, and resumes, bit for bit. Every test skips without a card.

This file imports neither JAX nor the JAX package's tests, so it runs on a
GPU machine without JAX. ``tests/conftest.py`` imports JAX, so skip it there:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import copy
import json
import os

import pytest
import torch

from highresnet_tpu_torch.ops import fusion, fusion_dma, lanczos_fused

# tests/test_train.py's TINY_CONFIG: channels 8, patch 16, register 32, batch 2, L 4
TINY_CONFIG = {
    "network": {
        "encoder": {"in_channels": 2, "num_layers": 1, "kernel_size": 3, "channel_size": 8},
        "recursive": {"alpha_residual": True, "in_channels": 8, "kernel_size": 3},
        "decoder": {
            "deconv": {"in_channels": 8, "kernel_size": 3, "stride": 3, "out_channels": 8},
            "final": {"in_channels": 8, "kernel_size": 1, "out_channels": 1},
        },
    },
    "training": {
        "batch_size": 2, "min_L": 4, "n_views": 4, "crop": 1, "lr": 1e-3, "lr_step": 2,
        "lr_decay": 0.97, "beta": 50.0, "create_patches": True, "patch_size": 16,
        "register_size": 32, "val_proportion": 0.34, "lambda": 1e-6, "num_epochs": 1,
        "n_workers": 2, "seed": 0, "eval_batch_size": 2, "use_pallas_warp": True,
    },
    "paths": {"prefix": "", "checkpoint_dir": "", "tb_log_file_dir": ""},
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 16, 64, 128, 128), (2, 5, 3, 7, 5), (1, 3, 5, 5, 5)])
def test_pack_pairs_cuda_bit_exact(shape, cuda):
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(shape, device=cuda).to(dtype)
        before = fusion.LAUNCHES["pack"]
        got = fusion.pack_pairs(x)
        assert fusion.LAUNCHES["pack"] == before + 1
        assert torch.equal(got, fusion.pack_pairs_ref(x))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 16, 64, 128, 128), (2, 5, 8, 4, 4), (3, 7, 8, 2, 4)])
def test_pack_pairs_dma_cuda_bit_exact(shape, cuda):
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(shape, device=cuda).to(dtype)
        before = fusion_dma.LAUNCHES
        got = fusion_dma.pack_pairs_dma(x)
        assert fusion_dma.LAUNCHES == before + 1
        assert torch.equal(got, fusion_dma.pack_pairs_ref(x))
    misaligned = [
        torch.zeros((2, 5, 3, 7, 5), device=cuda, dtype=torch.bfloat16),  # 210-byte view blocks
        torch.zeros(2 * 4 * 8 * 16 + 1, device=cuda)[1:].view(2, 4, 8, 4, 4),  # base 4 bytes in
    ]
    for x in misaligned:
        with pytest.raises(ValueError, match="16-byte aligned"):
            fusion_dma.pack_pairs_dma_cuda(x)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 4, 128, 64, 64), (2, 5, 3, 7, 5), (1, 3, 5, 5, 5)])
def test_unpack_pairs_cuda_bit_exact_and_grads(shape, cuda):
    b, l, c, h, w = shape
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.randn((b, l // 2, 2 * c, h, w), device=cuda).to(dtype)
        before = fusion.LAUNCHES["unpack"]
        got = fusion.unpack_pairs_cuda(g, l)
        assert fusion.LAUNCHES["unpack"] == before + 1
        assert torch.equal(got, fusion.unpack_pairs_ref(g, l))
    x = torch.randn(shape, device=cuda, requires_grad=True)
    gy = torch.randn((b, l // 2, 2 * c, h, w), device=cuda)
    (gx,) = torch.autograd.grad(fusion.pack_pairs(x), x, gy)
    xc = x.detach().cpu().requires_grad_()
    (want,) = torch.autograd.grad(fusion.pack_pairs(xc), xc, gy.cpu())
    assert torch.equal(gx.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 192, 192), (3, 17, 23), (2, 4, 9)])
def test_lanczos_shift_cuda_matches_plain(shape, cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    img = torch.rand(shape, generator=gen, device=cuda)
    shift = (torch.rand((shape[0], 2), generator=gen, device=cuda) * 6 - 3).requires_grad_()
    shift.data[0] = torch.tensor([1.0, -2.0])  # integer shifts: the sinc guard
    before = lanczos_fused.LAUNCHES
    got = lanczos_fused.lanczos_shift_fused(img.requires_grad_(), shift)
    assert lanczos_fused.LAUNCHES == before + 1
    want = lanczos_fused.lanczos_shift_ref(img, shift)
    assert (got - want).abs().max().item() <= 1e-5
    direct = lanczos_fused.lanczos_shift_cuda(img.detach(), shift.detach())
    assert lanczos_fused.LAUNCHES == before + 2 and torch.equal(direct, got)
    zero = lanczos_fused.lanczos_shift_cuda(img.detach(), torch.zeros_like(shift.detach()))
    assert (zero - img).abs().max().item() <= 1e-6
    g = torch.randn(shape, generator=gen, device=cuda)
    gi, gs = torch.autograd.grad(got, (img, shift), g)
    wi, ws = torch.autograd.grad(want, (img, shift), g)
    assert torch.equal(gi, wi) and torch.equal(gs, ws)
    with pytest.raises(ValueError, match="H, W >= 4"):
        lanczos_fused.lanczos_shift_fused(img[:, :3], shift)
    with pytest.raises(ValueError, match="shift must be"):
        lanczos_fused.lanczos_shift_cuda(img.detach(), shift.detach()[:, :1].contiguous())


@pytest.mark.cuda
def test_lanczos_shift_cuda_reads_one_image_expanded_over_the_batch(cuda):
    """An (H, W) image expanded over B (stride 0), as frac_cpsnr warps one
    SR 625 ways, gives the contiguous copy's output bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    sr = torch.rand((36, 36), generator=gen, device=cuda)
    shift = torch.rand((25, 2), generator=gen, device=cuda) * 6 - 3
    img = sr.expand(25, 36, 36)
    got = lanczos_fused.lanczos_shift_fused(img, shift)
    assert torch.equal(got, lanczos_fused.lanczos_shift_cuda(img.contiguous(), shift))
    assert (got - lanczos_fused.lanczos_shift_ref(img, shift)).abs().max().item() <= 1e-5
    with pytest.raises(ValueError, match="contiguous img"):
        lanczos_fused.lanczos_shift_cuda(sr.t().expand(25, 36, 36), shift)


@pytest.fixture
def deterministic(cuda):
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield cuda
    torch.use_deterministic_algorithms(before)


def _device_ops(fn):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.cuda
def test_no_wrapper_launches_a_fill(deterministic):
    """Under deterministic algorithms torch.empty launches a NaN fill; each
    kernel's wrapper launches its kernel alone, since its output comes from
    kernels.alloc.empty_output."""
    cuda = deterministic
    assert any("fill" in name.lower() for name in _device_ops(lambda: torch.empty(64, device=cuda)))
    x = torch.randn((2, 5, 8, 4, 4), device=cuda)
    g = torch.randn((2, 2, 16, 4, 4), device=cuda)
    img, shift = torch.rand((2, 8, 12), device=cuda), torch.rand((2, 2), device=cuda)
    for fn, kernel in ((lambda: fusion.pack_pairs_cuda(x), "pack_pairs_kernel"),
                       (lambda: fusion.unpack_pairs_cuda(g, 5), "unpack_pairs_kernel"),
                       (lambda: lanczos_fused.lanczos_shift_cuda(img, shift), "lanczos_shift_kernel"),
                       (lambda: fusion_dma.pack_pairs_dma_cuda(x), "pack_pairs_dma_kernel")):
        ops = _device_ops(fn)
        assert len(ops) == 1 and kernel in ops[0], ops


@pytest.mark.cuda
def test_lanczos_shift_forward_is_one_kernel(deterministic):
    cuda = deterministic
    img = torch.rand((8, 192, 192), device=cuda, requires_grad=True)
    shift = (torch.rand((8, 2), device=cuda) * 6 - 3).requires_grad_()
    ops = _device_ops(lambda: lanczos_fused.LanczosShift.apply(img, shift))
    assert len(ops) == 1 and "lanczos_shift_kernel" in ops[0], ops


@pytest.mark.cuda
def test_stacked_tta_equals_member_loop_bit_for_bit(cuda):
    """x8 registered TTA at the flagship's serving shape (64 channels, 16
    views of 128 px, 9-16 real): the stacked forward's SR equals, bit for
    bit, that of the eight members run one forward each and aligned and
    averaged the same way. A member off by one ulp can move its 1/100 px PCC
    shift by a step (``models/layers.py``)."""
    from pathlib import Path

    from highresnet_tpu_torch.config import load_config
    from highresnet_tpu_torch.eval.evaluator import Forward
    from highresnet_tpu_torch.models.network import build_network
    from highresnet_tpu_torch.ops.dihedral import dihedral_fwd, dihedral_inv
    from highresnet_tpu_torch.registration.search import pcc_align_batch
    from highresnet_tpu_torch.runtime import setup_device

    setup_device(cuda)
    config = load_config(str(Path(__file__).parents[1] / "configs" / "flagship.json"))
    model = build_network(config, cuda, torch.Generator().manual_seed(0))
    fwd = Forward.tta(model, cuda, 8, host=False)
    g = torch.Generator(device=cuda).manual_seed(1)
    for real in (16, 12, 9):
        lrs = torch.rand((1, 16, 128, 128), generator=g, device=cuda)
        lrs[:, real:] = 0.0
        alphas = (torch.arange(16, device=cuda) < real).float()[None]
        with torch.inference_mode():
            got = fwd(lrs, alphas)
            srs = [dihedral_inv(model(dihedral_fwd(lrs, t), alphas), t) for t in range(8)]
            aligned, _ = pcc_align_batch(srs[0].repeat(7, 1, 1), torch.cat(srs[1:]))
            want = torch.stack([srs[0], *aligned.split(1)]).mean(dim=0)
        assert torch.equal(got, want), real


def _final_state(run_dir):
    with open(os.path.join(run_dir, "latest.json")) as f:
        latest = json.load(f)
    return latest, torch.load(os.path.join(run_dir, latest["slot"], "state.pt"),
                              map_location="cpu", weights_only=True)


def _assert_same_state(a, b):
    (latest_a, sa), (latest_b, sb) = a, b
    assert latest_a["val_history"] == latest_b["val_history"]
    assert sa["step"] == sb["step"] > 0
    for model in ("hrnet", "shiftnet"):
        for k in sa[model]:
            assert torch.equal(sa[model][k], sb[model][k]), (model, k)
    for pa, pb in zip(sa["optimizer"]["state"].values(), sb["optimizer"]["state"].values()):
        assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert torch.equal(sa["generator"], sb["generator"])


@pytest.mark.cuda
def test_cli_train_on_gpu_repeats_and_resumes_bit_identical(cuda, tmp_path):
    """Deterministic mode on the card: two 2-epoch runs, and a 1 + 1 epoch
    resumed run, end in the same state, dropout masks included."""
    from highresnet_tpu_torch.cli.train import main as train_main
    from highresnet_tpu_torch.data import make_synthetic_dataset

    root = make_synthetic_dataset(str(tmp_path / "data"), n_scenes_per_channel=2, n_views=5,
                                  lr_size=24, seed=0, splits=("train",))
    configs = {}
    for epochs in (1, 2):
        cfg = copy.deepcopy(TINY_CONFIG)
        cfg["training"]["num_epochs"] = epochs
        cfg["paths"]["prefix"] = root
        configs[epochs] = str(tmp_path / f"epochs{epochs}.json")
        with open(configs[epochs], "w") as f:
            json.dump(cfg, f)

    def run(epochs, run_dir):
        train_main(["--config", configs[epochs], "--run-dir", str(tmp_path / run_dir),
                    "--device", "cuda"])
        return str(tmp_path / run_dir)

    first, second = run(2, "first"), run(2, "second")
    run(1, "resumed")
    resumed = run(2, "resumed")
    _assert_same_state(_final_state(first), _final_state(second))
    _assert_same_state(_final_state(first), _final_state(resumed))
