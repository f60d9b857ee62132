"""Drive the PyTorch port's serving and training paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints lines; any failure raises, so the exit code is not 0):
  1. card name and power limit (nvidia-smi), torch/CUDA versions, device setup;
  2. build the CUDA kernels from ``highresnet_tpu_torch/csrc``;
  3. [pack] the pair-pack kernel (K1) against its plain PyTorch version:
     ``torch.equal`` at the headline shape (f32, bf16) and at odd shapes (K1
     is timed in [dma]);
  4. [unpack] the unpack kernel (K2) the same way at the first-round training
     shape and at odd view counts, then gradients through ``PackPairs`` on
     the card against the CPU plain version's autograd, bit for bit; K2
     timed in turns with K1 on a pack that moves the same bytes, the plain
     version and ``index_select``;
  5. [warp] the Lanczos warp kernel (K3, taps computed inside it) against
     its plain version (limit 1e-5) at the training shape and two odd
     shapes, zero shift, gradients of ``LanczosShift`` against the plain
     autograd, the in-kernel taps against ``lanczos_kernel``, and K3 and the
     plain version (taps included) timed;
  6. [predict] the predict CLI end to end on a synthetic 16-view 128 px
     dataset with the full-width network of configs/config.json and seeded
     random weights; K1's launches in that run; the first scene's SR and
     score against the port's CPU path;
  7. [forward] HRNet forward time at the bench headline (batch 8, 16 views,
     128 px, f32), with the kernel and with the plain pack;
  8. [train] the train CLI end to end on a synthetic 8-view 128 px dataset
     at the full width of configs/config.json with the fused warp on; the
     launches of K1, K2 and K3 in that run against the count its steps and
     val forwards imply; a finite loss; ``best/HRNet.pth`` served by the
     predict CLI; one step on the GPU against the port's CPU path (dropout
     off); the train step timed with the kernels and with the plain versions.
     The predict and train runs launch K4 no time.
  9. [dma] the bulk-copy pair pack (K4) against ``pack_pairs_ref``:
     ``torch.equal`` at the lab shape (bf16, f32) and at odd view counts,
     the ``ValueError`` on a misaligned view block, then K4, K1, the plain
     version and ``index_select`` timed in turns at the lab shape (bf16) and
     the headline (f32), each with its GB/s and share of the byte bound;
 10. [lab4] ``highresnet_tpu_torch.labs.fusion_lab4.main`` on the card with few
     iterations: K4 correct, its launches and K1's as the lab ran them, pair
     and split conv within bf16 rounding, finite bf16 forwards at batch 16
     and 32, and the bf16 forward at batch 16 against the f32 forward of the
     same weights inside the JAX package's bf16 envelope;
 11. [fills] each kernel's wrapper once under torch.profiler: its kernel is
     the one device operation it launches (no NaN fill of its output under
     deterministic algorithms), and so is the forward of ``LanczosShift``;
     then the fill that ``torch.empty`` would launch, timed at each kernel's
     timed output shape, the host time of ``torch.empty`` against
     ``kernels.alloc.empty_output`` at the same shapes, and each wrapper's
     host time per call.
Each bit-exact or tolerance check of K1-K4 reads an output that the kernel
wrote into a block just filled with NaN and freed (``poison``), so a byte
the kernel leaves unwritten shows. Kernel times: ``ms`` is device time per
call, from a CUDA graph of 20 back-to-back calls replayed between two
events (median of 10 replays); ``call_ms`` is one call between two events,
the wrapper's host part included (median of 20), the series of the earlier
runs. ``plain_ms`` and ``library_ms`` use the graph timer too.
Then one JSON line with the kernels (``launches`` sums the predict, train and
lab runs; ``bound_ms`` is the least time the card could take for the timed
call, from its bytes at 3.35 TB/s and its operations at the peak rate of
their type; ``library_ms`` is one PyTorch call computing the same function,
or null), the card line again, and last the device JSON line.
Needs CUDA; it imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
HEADLINE = dict(batch=8, views=16, size=128)
TRAIN = dict(views=8, size=128, scenes_per_channel=9, max_steps=4)  # 16 train scenes: 2 batches of 8
SR_RTOL = 1e-4  # GPU vs CPU SR: max |diff| / max |cpu|
SCORE_ATOL_DB = 0.01  # the repo's parity contract
WARP_ATOL = 1e-5  # K3 vs its plain version on [0, 1] images
ZERO_SHIFT_ATOL = 1e-6  # a zero shift returns the image
STEP_LOSS_RTOL = 1e-4  # one train step, GPU vs CPU port: loss
STEP_GRAD_NORM_RTOL = 1e-3  # and the gradient norm (f32, TF32 off, other conv algorithms)
LAB = dict(batch=8, views=16, channels=64, size=128)  # examples/fusion_lab4.py's pack shape
LAB_ITERS, LAB_WARMUP = 3, 1
# pair vs split conv in bf16: each side rounds to bf16 (pair once, split its
# two partials and their sum), each rounding at most half an ulp, 2^-9 of
# the value; four of them stay under 2^-7 of max|pair|, and 2^-6 leaves 2x room
SPLIT_CONV_RTOL = 2.0 ** -6
# bf16 vs f32 forward, tests/test_precision.py's envelope on [0.1, 0.9]-normalised
# outputs, here also relative to max|f32|
BF16_RMS, BF16_MAX = 3e-3, 1.5e-2
GRAPH_CALLS, GRAPH_REPLAYS = 20, 10  # kernel times: calls per CUDA graph, replays timed
HOST_CALLS = 200  # host time of an allocation: calls timed
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores


def cuda_times_ms(fn, iters: int, warmup: int) -> list[float]:
    """One call between two CUDA events, ``iters`` times: host and device
    time together (the wrapper's checks, the ctypes launch, the kernel)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def graph_times_ms(fns: dict, calls: int = GRAPH_CALLS, replays: int = GRAPH_REPLAYS) -> dict:
    """Device time per call of each function: ``calls`` back-to-back calls
    captured in one CUDA graph, the graph replayed between two events, the
    time divided by ``calls``; the graphs replayed in turns, so drift hits
    every function alike, and the median of ``replays`` kept. The launches
    that the warm-up and the capture count are taken back."""
    from highresnet_tpu_torch.kernels import build

    build.load()  # never inside a capture
    saved = read_counts()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as torch.cuda.graph asks
        for fn in fns.values():
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graphs = {}
    for name, fn in fns.items():
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            for _ in range(calls):
                fn()
    write_counts(saved)
    for graph in graphs.values():
        graph.replay()
    times = {name: [] for name in graphs}
    for _ in range(replays):
        for name, graph in graphs.items():
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / calls)
    return {name: statistics.median(ts) for name, ts in times.items()}


def host_us(fn, calls: int = HOST_CALLS, warmup: int = 20) -> float:
    """Host time of one call of ``fn`` on the CPU clock, median of ``calls``;
    the card is drained between calls, outside the timed span."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e6)
        del out
    torch.cuda.synchronize()
    return statistics.median(times)


def poison(shape, dtype) -> int:
    """Fill a block of an output's size with NaN and free it: the caching
    allocator hands that block to the next allocation of the same size, so
    a byte the kernel leaves unwritten reads as NaN. Returns its address."""
    torch.cuda.empty_cache()  # no other free block of that size to choose
    block = torch.full(shape, float("nan"), dtype=dtype, device="cuda")
    address = block.data_ptr()
    del block
    return address


def check_poisoned(out: torch.Tensor, address: int, what: str) -> None:
    if out.data_ptr() != address:
        raise AssertionError(f"{what}: the output did not land in the NaN-filled block")


def device_ops(fn) -> list[str]:
    """Names of the device operations (kernels, copies, memsets) that ``fn``
    launches, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def bound_ms(bytes_moved: float, flops: float = 0.0) -> float:
    """The least time the card could take: bytes at the memory rate, or the
    operations at the f32 peak, whichever is larger."""
    return max(bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3


def paired_bytes(x: torch.Tensor) -> int:
    """Bytes a pair pack of x moves: each paired view read once, written once."""
    return 2 * x.numel() // x.shape[1] * 2 * (x.shape[1] // 2) * x.element_size()


def unpack_index_select(g: torch.Tensor, inverse: torch.Tensor) -> torch.Tensor:
    """K2's library yardstick for an even view count: one index_select by
    the inverse of the pair order."""
    b, half, c2, h, w = g.shape
    return torch.index_select(g.view(b, 2 * half, c2 // 2, h, w), 1, inverse)


def phase_pack(fusion) -> dict:
    """K1 against pack_pairs_ref: bit-exact at the headline and odd shapes,
    its output in a NaN-filled block (timed in [dma])."""
    g = torch.Generator(device="cuda").manual_seed(0)
    b, l, s = HEADLINE["batch"], HEADLINE["views"], HEADLINE["size"]
    shapes = [(b, l, 64, s, s), (2, 5, 3, 7, 5), (3, 5, 1, 3, 3), (1, 3, 5, 5, 5)]
    max_err = 0.0
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=g, device="cuda").to(dtype)
            address = poison((shape[0], shape[1] // 2, 2 * shape[2], *shape[3:]), dtype)
            got = fusion.pack_pairs_cuda(x)
            check_poisoned(got, address, f"pack_pairs_cuda at {shape} {dtype}")
            want = fusion.pack_pairs_ref(x)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"pack_pairs_cuda != pack_pairs_ref at {shape} {dtype}")
            max_err = max(max_err, (got.float() - want.float()).abs().max().item())
            print(f"[pack] torch.equal(kernel, plain) at {shape} {dtype}, output in a "
                  f"NaN-filled block: True")

    return {"max_abs_err": max_err}


def write_counts(counts: dict) -> None:
    from highresnet_tpu_torch.ops import fusion, fusion_dma, lanczos_fused

    for k in fusion.LAUNCHES:
        fusion.LAUNCHES[k] = counts[k]
    lanczos_fused.LAUNCHES = counts["lanczos"]
    fusion_dma.LAUNCHES = counts["pack_dma"]


def reset_counts() -> None:
    write_counts(dict.fromkeys(("pack", "unpack", "lanczos", "pack_dma"), 0))


def read_counts() -> dict:
    from highresnet_tpu_torch.ops import fusion, fusion_dma, lanczos_fused

    return {**fusion.LAUNCHES, "lanczos": lanczos_fused.LAUNCHES, "pack_dma": fusion_dma.LAUNCHES}


def phase_unpack(fusion, card: str) -> dict:
    """K2 against unpack_pairs_ref bit for bit, its output in a NaN-filled
    block; PackPairs gradients on the card against the CPU plain version's
    autograd; K2 timed in turns with K1 on a pack that moves the same bytes,
    the plain version and index_select."""
    g = torch.Generator(device="cuda").manual_seed(1)
    # (B, L, 2C, H, W): the cotangent of an L-view pack is (B, L//2, 2C, H, W)
    first_round = (8, TRAIN["views"], 128, 64, 64)
    cases = [(first_round, torch.float32), (first_round, torch.bfloat16),
             ((2, 5, 6, 7, 5), torch.float32), ((3, 3, 2, 3, 3), torch.bfloat16),
             ((1, 3, 10, 5, 5), torch.float32), ((1, 3, 10, 5, 5), torch.bfloat16)]
    max_err = 0.0
    for (b, l, c2, h, w), dtype in cases:
        cot = torch.randn((b, l // 2, c2, h, w), generator=g, device="cuda").to(dtype)
        address = poison((b, l, c2 // 2, h, w), dtype)
        got = fusion.unpack_pairs_cuda(cot, l)
        check_poisoned(got, address, f"unpack_pairs_cuda at L={l} {tuple(cot.shape)} {dtype}")
        want = fusion.unpack_pairs_ref(cot, l)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"unpack_pairs_cuda != unpack_pairs_ref at L={l} {cot.shape} {dtype}")
        max_err = max(max_err, (got.float() - want.float()).abs().max().item())
        print(f"[unpack] torch.equal(kernel, plain) at L={l}, cotangent {tuple(cot.shape)} {dtype}, "
              f"output in a NaN-filled block: True")

    for shape in ((8, 8, 64, 64, 64), (2, 5, 3, 7, 5), (1, 3, 4, 5, 5)):
        x = torch.randn(shape, generator=g, device="cuda", requires_grad=True)
        cot = torch.randn((shape[0], shape[1] // 2, 2 * shape[2], *shape[3:]), generator=g,
                          device="cuda")
        before = fusion.LAUNCHES["unpack"]
        y = fusion.pack_pairs(x)
        poison(shape, torch.float32)  # for the backward's K2 output
        (gx,) = torch.autograd.grad(y, x, cot)
        xc = x.detach().cpu().requires_grad_()
        (want,) = torch.autograd.grad(fusion.pack_pairs(xc), xc, cot.cpu())
        if fusion.LAUNCHES["unpack"] != before + 1 or not torch.equal(gx.cpu(), want):
            raise AssertionError(f"PackPairs backward on CUDA != CPU autograd at {shape}")
        print(f"[unpack] PackPairs grad on CUDA == CPU plain autograd at {shape}: True")

    from highresnet_tpu_torch.ops.fusion_dma import pair_order

    l = TRAIN["views"]
    cot = torch.randn((8, l // 2, 128, 64, 64), generator=g, device="cuda")
    x = torch.randn((8, l, 64, 64, 64), generator=g, device="cuda")  # K1: the same bytes
    inverse = torch.argsort(pair_order(l, cot.device))
    if not torch.equal(unpack_index_select(cot, inverse), fusion.unpack_pairs_ref(cot, l)):
        raise AssertionError("the index_select yardstick is not the unpack")
    moved = 2 * cot.numel() * cot.element_size()  # bytes read + bytes written
    if paired_bytes(x) != moved:
        raise AssertionError("K1's pack does not move K2's bytes")
    routes = {"K2": lambda: fusion.unpack_pairs_cuda(cot, l),
              "K1 (pack, same bytes)": lambda: fusion.pack_pairs_cuda(x),
              "plain": lambda: fusion.unpack_pairs_ref(cot, l),
              "index_select": lambda: unpack_index_select(cot, inverse)}
    ms = graph_times_ms(routes)
    call_ms = statistics.median(cuda_times_ms(routes["K2"], 20, 3))
    bound = bound_ms(moved)
    print(f"[unpack] cotangent {tuple(cot.shape)} f32 -> L={l}, {moved / 1e6:.1f} MB moved; "
          "device time per call (CUDA graph of " + f"{GRAPH_CALLS} calls, median of "
          f"{GRAPH_REPLAYS} replays, in turns): " + ", ".join(
              f"{name} {t:.4f} ms ({moved / t / 1e6:.1f} GB/s, {bound / t:.1%} of the byte bound)"
              for name, t in ms.items())
          + f"; K2 one call with its host part {call_ms:.4f} ms (median of 20); bound "
          f"{bound:.4f} ms; {card}")
    return {"max_abs_err": max_err, "ms": ms["K2"], "call_ms": call_ms, "plain_ms": ms["plain"],
            "bound_ms": bound, "bound_by": "bytes", "library_ms": ms["index_select"]}


def kernel_taps(lanczos_fused, shift: torch.Tensor) -> torch.Tensor:
    """K3's in-kernel taps (B, 2, 7), read back through line images: a
    horizontal line at row c comes out as ky[t] at row c + 3 - t, times the
    sum of kx (1 within rounding), and a vertical line likewise gives kx."""
    n, c = 16, 8
    t = torch.arange(7, device="cuda")
    rows = torch.zeros((shift.shape[0], n, n), device="cuda")
    rows[:, c] = 1.0
    ky = lanczos_fused.lanczos_shift_cuda(rows, shift)[:, c + 3 - t, n // 2]
    kx = lanczos_fused.lanczos_shift_cuda(rows.transpose(1, 2).contiguous(), shift)[:, n // 2, c + 3 - t]
    return torch.stack([ky, kx], dim=1)


def phase_warp(lanczos_fused, card: str) -> dict:
    """K3 against lanczos_shift_ref, its output in a NaN-filled block;
    LanczosShift gradients against the plain autograd; the in-kernel taps
    against lanczos_kernel; K3 and the plain version timed."""
    from highresnet_tpu_torch.ops.lanczos import lanczos_kernel

    g = torch.Generator(device="cuda").manual_seed(2)
    max_err = 0.0
    for shape in ((8, 3 * 64, 3 * 64), (3, 17, 23), (2, 4, 9)):
        img = torch.rand(shape, generator=g, device="cuda")
        shift = torch.rand((shape[0], 2), generator=g, device="cuda") * 6 - 3
        address = poison(shape, torch.float32)
        got = lanczos_fused.LanczosShift.apply(img, shift)
        check_poisoned(got, address, f"LanczosShift at {shape}")
        want = lanczos_fused.lanczos_shift_ref(img, shift)
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        print(f"[warp] {shape} shifts in ±3 px, output in a NaN-filled block: max|kernel - plain| "
              f"{err:.3e} (limit {WARP_ATOL})")
        if not err <= WARP_ATOL:
            raise AssertionError(f"lanczos kernel disagrees with its plain version at {shape}")

        img.requires_grad_()
        shift.requires_grad_()
        cot = torch.randn(shape, generator=g, device="cuda")
        got_g = torch.autograd.grad(lanczos_fused.LanczosShift.apply(img, shift), (img, shift), cot)
        want_g = torch.autograd.grad(lanczos_fused.lanczos_shift_ref(img, shift), (img, shift), cot)
        if not all(torch.equal(a, b) for a, b in zip(got_g, want_g)):
            raise AssertionError(f"LanczosShift gradients differ from the plain autograd at {shape}")
        print(f"[warp] {shape} LanczosShift grads (image, shift) == plain autograd: True")

    img = torch.rand((8, 192, 192), generator=g, device="cuda")
    address = poison(img.shape, torch.float32)
    zero = lanczos_fused.LanczosShift.apply(img, torch.zeros((8, 2), device="cuda"))
    check_poisoned(zero, address, "LanczosShift at zero shift")
    z_err = (zero - img).abs().max().item()
    print(f"[warp] zero shift, output in a NaN-filled block: max|out - img| {z_err:.3e} "
          f"(limit {ZERO_SHIFT_ATOL})")
    if not z_err <= ZERO_SHIFT_ATOL:
        raise AssertionError("a zero shift does not return the image")

    shift = torch.rand((8, 2), generator=g, device="cuda") * 6 - 3
    shift[:4] = torch.tensor([[0.0, 1.0], [-3.0, 2.0], [0.5, -0.5], [2.999, -1e-7]], device="cuda")
    taps = torch.stack([lanczos_kernel(shift[:, i]) for i in (0, 1)], dim=1)
    tap_err = (kernel_taps(lanczos_fused, shift) - taps).abs().max().item()
    print(f"[warp] in-kernel taps (read back through line images) vs lanczos_kernel on the card, "
          f"shifts in ±3 px with integers: max|diff| {tap_err:.3e}")

    ms = graph_times_ms({"K3": lambda: lanczos_fused.lanczos_shift_cuda(img, shift),
                         "plain": lambda: lanczos_fused.lanczos_shift_ref(img, shift)})
    call_ms = statistics.median(cuda_times_ms(
        lambda: lanczos_fused.lanczos_shift_cuda(img, shift), 20, 3))
    # the image read and written, the shifts read; two 7-tap passes, a multiply
    # and an add per tap (the 14 taps per image are a few hundred operations more)
    moved = 2 * img.numel() * img.element_size() + shift.numel() * shift.element_size()
    flops = 2 * 2 * 7 * img.numel()
    bound = bound_ms(moved, flops)
    bound_by = "bytes" if moved / HBM_BYTES_PER_S >= flops / F32_FLOPS else "operations"
    print(f"[warp] (8, 192, 192) f32, taps in the kernel: device time per call (CUDA graph of "
          f"{GRAPH_CALLS} calls, median of {GRAPH_REPLAYS} replays, in turns) K3 {ms['K3']:.4f} ms "
          f"({moved / ms['K3'] / 1e6:.1f} GB/s), plain (taps included) {ms['plain']:.4f} ms; K3 one "
          f"call with its host part {call_ms:.4f} ms (median of 20); bound {bound * 1e3:.3f} us "
          f"({moved / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP; {bound_by}); no single PyTorch call; "
          f"{card}")
    return {"max_abs_err": max_err, "ms": ms["K3"], "call_ms": call_ms, "plain_ms": ms["plain"],
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None}


def phase_predict(fusion, lanczos_fused, card: str) -> dict:
    """The predict CLI end to end; returns the kernel launch counts in it."""
    from highresnet_tpu_torch import load_config
    from highresnet_tpu_torch.cli import predict
    from highresnet_tpu_torch.data import collate, make_synthetic_dataset
    from highresnet_tpu_torch.eval.evaluator import Model, load_data
    from highresnet_tpu_torch.models.hrnet import HRNet, param_count

    views, size = HEADLINE["views"], HEADLINE["size"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = make_synthetic_dataset(
            os.path.join(tmp, "data"), n_scenes_per_channel=2, n_views=views,
            lr_size=size, seed=0,
        )
        cfg = load_config(str(REPO / "configs" / "config.json"))
        cfg["paths"]["prefix"] = root
        cfg["training"]["min_L"] = views
        cfg_path = os.path.join(tmp, "config.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        run_dir = os.path.join(tmp, "run")
        os.makedirs(run_dir)
        model = HRNet(cfg["network"], generator=torch.Generator().manual_seed(0))
        n_params = param_count(model)
        torch.save(model.state_dict(), os.path.join(run_dir, "HRNet.pth"))

        reset_counts()
        table = predict.main([
            "--config", cfg_path, "--checkpoint", run_dir,
            "--splits", "train", "val", "--device", "cuda",
        ])
        counts = read_counts()
        launches = counts["pack"]
        scores = table["model"].astype(float).to_dict()
        rounds = int(np.log2(views))
        print(f"[predict] {len(scores)} scenes, {n_params} params, pack launches "
              f"{launches} (expected {rounds} per forward), scores {scores}")
        if counts != {"pack": rounds * len(scores), "unpack": 0, "lanczos": 0, "pack_dma": 0}:
            raise AssertionError(f"expected {rounds * len(scores)} pack launches only, got {counts}")
        if not all(np.isfinite(v) for v in scores.values()):
            raise AssertionError(f"non-finite scores: {scores}")

        imset = load_data(cfg_path)[0][0]
        gpu, cpu = Model(cfg, device="cuda"), Model(cfg, device="cpu")
        gpu.load_checkpoint(run_dir)
        cpu.load_checkpoint(run_dir)
        before = dict(fusion.LAUNCHES)
        sr_cpu, score_cpu = cpu(collate([imset], views))
        if fusion.LAUNCHES != before:
            raise AssertionError("the CPU path launched the CUDA kernel")
        sr_gpu, score_gpu = gpu(collate([imset], views))
        if sr_gpu.shape != (3 * size, 3 * size) or not np.all(np.isfinite(sr_gpu)):
            raise AssertionError(f"bad SR: shape {sr_gpu.shape}")
        rel = float(np.max(np.abs(sr_gpu - sr_cpu)) / np.max(np.abs(sr_cpu)))
        d_db = abs(score_gpu - score_cpu)
        print(f"[predict] scene {imset.name} GPU vs CPU port: SR max|diff|/max|cpu| {rel:.3e} "
              f"(limit {SR_RTOL}), shift-cPSNR {score_gpu:.6f} vs {score_cpu:.6f} dB, "
              f"|diff| {d_db:.2e} dB (limit {SCORE_ATOL_DB}); CLI score "
              f"{scores[imset.name]:.6f}; {card}")
        if rel > SR_RTOL or d_db > SCORE_ATOL_DB:
            raise AssertionError("GPU and CPU paths of the port disagree")
        if abs(scores[imset.name] - score_gpu) > 1e-9:
            raise AssertionError("the CLI's score differs from a rerun on the same device")
    return counts


def phase_forward(card: str) -> None:
    from highresnet_tpu_torch import load_config
    from highresnet_tpu_torch.models.hrnet import HRNet

    b, l, s = HEADLINE["batch"], HEADLINE["views"], HEADLINE["size"]
    net = load_config(str(REPO / "configs" / "config.json"))["network"]
    rng = np.random.default_rng(0)
    lrs = torch.from_numpy(rng.random((b, l, s, s), dtype=np.float32)).cuda()
    alphas = torch.ones((b, l), device="cuda")
    models = {}
    for name, flag in (("kernel", None), ("plain", False)):
        cfg = {**net, "recursive": {**net["recursive"], "use_pallas_pack": flag}}
        models[name] = HRNet(cfg, device="cuda", generator=torch.Generator().manual_seed(0)).eval()
    times = {name: [] for name in models}
    with torch.inference_mode():
        outs = {name: m(lrs, alphas) for name, m in models.items()}
        if not torch.equal(outs["kernel"], outs["plain"]):
            raise AssertionError("forward with the kernel differs from the plain-pack forward")
        for _ in range(10):  # interleaved, so drift hits both alike
            for name, m in models.items():
                times[name] += cuda_times_ms(lambda: m(lrs, alphas), 1, 1)
    for name, ts in times.items():
        ms = statistics.median(ts)
        print(f"[forward] HRNet f32 batch {b} x {l} views x {s}px, pack={name}: "
              f"{ms:.3f} ms/batch, {b / ms * 1e3:.1f} scenes/s (median of 10); {card}")


def train_config(tmp: str) -> tuple[dict, str]:
    """configs/config.json on a synthetic 8-view 128 px set, fused warp on."""
    from highresnet_tpu_torch import load_config
    from highresnet_tpu_torch.data import make_synthetic_dataset

    root = make_synthetic_dataset(
        os.path.join(tmp, "data"), n_scenes_per_channel=TRAIN["scenes_per_channel"],
        n_views=TRAIN["views"], lr_size=TRAIN["size"], seed=0, splits=("train",),
    )
    cfg = load_config(str(REPO / "configs" / "config.json"))
    cfg["paths"].update(prefix=root, checkpoint_dir=os.path.join(tmp, "runs"), tb_log_file_dir="")
    cfg["training"].update(min_L=TRAIN["views"], n_views=TRAIN["views"], use_pallas_warp=True)
    path = os.path.join(tmp, "config.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return cfg, path


def phase_train(fusion, lanczos_fused, card: str, tmp: str) -> dict:
    """The train CLI end to end; returns the kernel launch counts in it."""
    from highresnet_tpu_torch.cli import predict, train
    from highresnet_tpu_torch.data import discover_scenes, train_val_split

    cfg, cfg_path = train_config(tmp)
    t = cfg["training"]
    run_dir = os.path.join(tmp, "run")
    reset_counts()
    out = train.main(["--config", cfg_path, "--run-dir", run_dir,
                      "--max-steps", str(TRAIN["max_steps"]), "--device", "cuda"])
    counts = read_counts()

    with open(os.path.join(run_dir, "latest.json")) as f:
        epochs = json.load(f)["epoch"]
    scenes = discover_scenes(os.path.join(cfg["paths"]["prefix"], "train"))
    _, val = train_val_split(scenes, t["val_proportion"], seed=1)
    rounds = int(np.log2(TRAIN["views"]))
    steps = TRAIN["max_steps"]
    val_forwards = epochs * -(-len(val) // t["eval_batch_size"])
    want = {"pack": rounds * (steps + val_forwards), "unpack": rounds * steps, "lanczos": steps,
            "pack_dma": 0}
    print(f"[train] cli.train: {steps} steps, {epochs} epochs, {val_forwards} val forwards; "
          f"launches {counts} (expected {want}); last epoch loss {out['train_loss']}, "
          f"best score {out['best_score']}")
    if counts != want:
        raise AssertionError(f"kernel launches {counts} != {want}")
    if not (np.isfinite(out["train_loss"]) and np.isfinite(out["best_score"])):
        raise AssertionError("non-finite train loss or val score")

    table = predict.main(["--config", cfg_path, "--checkpoint", run_dir,
                          "--splits", "val", "--device", "cuda"])
    scores = table["model"].astype(float).to_dict()
    print(f"[train] best/HRNet.pth served by cli.predict: scores {scores}")
    if not scores or not all(np.isfinite(v) for v in scores.values()):
        raise AssertionError(f"cli.predict on the run dir gave {scores}")
    return counts


def _step_pieces(cfg: dict, device: str, batch):
    from highresnet_tpu_torch.train.epoch import batch_to_device
    from highresnet_tpu_torch.train.state import create_train_state
    from highresnet_tpu_torch.train.step import build_train_step

    state = create_train_state(cfg, device, torch.Generator().manual_seed(0))
    state.shiftnet.dropout = 0.0
    return state, build_train_step(cfg), batch_to_device(batch, torch.device(device))


def phase_train_step(card: str, tmp: str) -> None:
    """One step from one init and batch on the GPU and on the port's CPU
    path; then the step timed with the kernels and with the plain versions."""
    from highresnet_tpu_torch.data import discover_scenes
    from highresnet_tpu_torch.train.setup import build_train_loader

    with open(os.path.join(tmp, "config.json")) as f:
        cfg = json.load(f)
    t = cfg["training"]
    scenes = discover_scenes(os.path.join(cfg["paths"]["prefix"], "train"))
    batch = next(iter(build_train_loader(t, scenes, seed=0)))
    metrics = {}
    for device in ("cuda", "cpu"):
        state, step, args = _step_pieces(cfg, device, batch)
        _, m = step(state, *args)
        metrics[device] = {k: v.item() for k, v in m.items()}
    d_loss = abs(metrics["cuda"]["loss"] - metrics["cpu"]["loss"]) / abs(metrics["cpu"]["loss"])
    d_norm = abs(metrics["cuda"]["grad_norm"] - metrics["cpu"]["grad_norm"]) / metrics["cpu"]["grad_norm"]
    print(f"[train] one step, GPU vs CPU port, dropout off: loss {metrics['cuda']['loss']:.7f} vs "
          f"{metrics['cpu']['loss']:.7f} (rel {d_loss:.2e}, limit {STEP_LOSS_RTOL}), grad_norm "
          f"{metrics['cuda']['grad_norm']:.7f} vs {metrics['cpu']['grad_norm']:.7f} "
          f"(rel {d_norm:.2e}, limit {STEP_GRAD_NORM_RTOL})")
    if d_loss > STEP_LOSS_RTOL or d_norm > STEP_GRAD_NORM_RTOL:
        raise AssertionError("GPU and CPU train steps of the port disagree")

    plain = json.loads(json.dumps(cfg))
    plain["network"]["recursive"]["use_pallas_pack"] = False
    plain["training"]["use_pallas_warp"] = False
    runs = {"kernels": _step_pieces(cfg, "cuda", batch), "plain": _step_pieces(plain, "cuda", batch)}
    times = {name: [] for name in runs}
    for name, (state, step, args) in runs.items():
        for _ in range(2):  # warm-up
            step(state, *args)
    for _ in range(10):  # interleaved, so drift hits both alike
        for name, (state, step, args) in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, *args)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    b, l, p = t["batch_size"], t["min_L"], t["patch_size"]
    for name, ts in times.items():
        ms = statistics.median(ts)
        print(f"[train] step batch {b} x {l} views x {p} px (SR {3 * p} px, register "
              f"{t.get('register_size', 128)}), {name}: {ms:.3f} ms/step, "
              f"{b / ms * 1e3:.1f} scenes/s (median of 10, host clock with sync); {card}")


def phase_dma(fusion, fusion_dma, card: str) -> dict:
    """K4 against pack_pairs_ref bit for bit, its output in a NaN-filled
    block, its refusal of a misaligned view block, and K4, K1, the plain
    version and index_select timed in turns. Returns K4's timings at the lab
    shape (bf16) and K1's at the headline (f32)."""
    g = torch.Generator(device="cuda").manual_seed(3)
    b, l, c, s = LAB["batch"], LAB["views"], LAB["channels"], LAB["size"]
    cases = [((b, l, c, s, s), torch.bfloat16), ((b, l, c, s, s), torch.float32),
             ((2, 5, 8, 4, 4), torch.float32), ((3, 7, 8, 2, 4), torch.bfloat16)]
    max_err = 0.0
    for shape, dtype in cases:
        x = torch.randn(shape, generator=g, device="cuda").to(dtype)
        address = poison((shape[0], shape[1] // 2, 2 * shape[2], *shape[3:]), dtype)
        got = fusion_dma.pack_pairs_dma_cuda(x)
        check_poisoned(got, address, f"pack_pairs_dma_cuda at {shape} {dtype}")
        want = fusion_dma.pack_pairs_ref(x)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"pack_pairs_dma_cuda != pack_pairs_ref at {shape} {dtype}")
        max_err = max(max_err, (got.float() - want.float()).abs().max().item())
        print(f"[dma] torch.equal(K4, plain) at {shape} {dtype}, output in a NaN-filled block: True")
    bad = torch.randn((2, 5, 3, 7, 5), generator=g, device="cuda").to(torch.bfloat16)
    try:
        fusion_dma.pack_pairs_dma_cuda(bad)
    except ValueError as e:
        print(f"[dma] {tuple(bad.shape)} bf16 ({3 * 7 * 5 * 2} B blocks) refused: {e}")
    else:
        raise AssertionError("K4 took a view block that is not 16-byte aligned")

    order = fusion_dma.pair_order(l, "cuda")
    routes = {"K4": fusion_dma.pack_pairs_dma_cuda, "K1": fusion.pack_pairs_cuda,
              "plain": fusion_dma.pack_pairs_ref,
              "index_select": lambda x: fusion_dma.pack_index_select(x, order)}
    rows = {}
    for kernel, dtype in (("K4", torch.bfloat16), ("K1", torch.float32)):  # lab shape, headline
        x = torch.randn((b, l, c, s, s), generator=g, device="cuda").to(dtype)
        moved = paired_bytes(x)
        bound = bound_ms(moved)
        ms = graph_times_ms({name: (lambda fn=fn: fn(x)) for name, fn in routes.items()})
        calls = {name: [] for name in routes}
        for fn in routes.values():
            cuda_times_ms(lambda: fn(x), 0, 3)
        for _ in range(20):  # in turns, so drift hits every route alike
            for name, fn in routes.items():
                calls[name] += cuda_times_ms(lambda: fn(x), 1, 0)
        call_ms = {name: statistics.median(ts) for name, ts in calls.items()}
        print(f"[dma] {tuple(x.shape)} {str(dtype)[6:]}: device time per call (CUDA graph of "
              f"{GRAPH_CALLS} calls, median of {GRAPH_REPLAYS} replays, in turns): " + ", ".join(
                  f"{name} {t:.4f} ms ({moved / t / 1e6:.1f} GB/s, {bound / t:.1%} of the byte "
                  f"bound)" for name, t in ms.items())
              + "; one call with its host part (median of 20, in turns): " + ", ".join(
                  f"{name} {t:.4f} ms" for name, t in call_ms.items())
              + f"; bound {bound:.4f} ms ({moved / 1e9:.3f} GB); {card}")
        rows[kernel] = {"ms": ms[kernel], "call_ms": call_ms[kernel], "plain_ms": ms["plain"],
                        "bound_ms": bound, "bound_by": "bytes", "library_ms": ms["index_select"]}
    return {"pack_dma": {"max_abs_err": max_err, **rows["K4"]}, "pack": rows["K1"]}


def phase_lab4(fusion, lanczos_fused, card: str, tmp: str) -> dict:
    """The fusion lab on the card; returns the kernel launch counts in it."""
    from highresnet_tpu_torch.config import DEFAULT_CONFIG
    from highresnet_tpu_torch.labs import fusion_lab4
    from highresnet_tpu_torch.models.hrnet import HRNet

    batches = (16, 32)
    reset_counts()
    report = fusion_lab4.main([
        "--device", "cuda", "--out", os.path.join(tmp, "fusion_lab4_torch.json"),
        "--iters", str(LAB_ITERS), "--warmup", str(LAB_WARMUP),
        "--fwd-batches", *map(str, batches),
    ])
    counts = read_counts()
    print(f"[lab4] report {json.dumps(report)}")
    calls = LAB_ITERS + LAB_WARMUP
    rounds = int(np.log2(LAB["views"]))
    want = {"pack": calls + rounds * (1 + calls) * len(batches), "unpack": 0, "lanczos": 0,
            "pack_dma": 1 + calls}
    print(f"[lab4] launches {counts} (expected {want}); pack_dma correct "
          f"{report['pack_dma']['correct']}")
    if counts != want or report["pack_dma"]["launches"] != want["pack_dma"]:
        raise AssertionError(f"kernel launches in the lab {counts} != {want}")
    if report["pack_dma"]["correct"] is not True:
        raise AssertionError("the lab's K4 output differs from pack_pairs_ref")
    split = report["splitconv"]
    limit = SPLIT_CONV_RTOL * split["max_abs_pair"]
    print(f"[lab4] max|pair - split| conv {split['max_abs_diff']:.4e} (limit {limit:.4e} = "
          f"2^-6 x max|pair| {split['max_abs_pair']:.4f})")
    if not split["max_abs_diff"] <= limit:
        raise AssertionError("pair and split conv disagree beyond bf16 rounding")
    for batch in batches:
        entry = report[f"fwd_bf16_batch{batch}"]
        print(f"[lab4] bf16 forward batch {batch} x {LAB['views']} views x {LAB['size']}px: "
              f"{entry['step_s'] * 1e3:.3f} ms, {entry['scenes_per_s']:.1f} scenes/s, finite "
              f"{entry['finite']} (median of {LAB_ITERS}); {card}")
        if entry["finite"] is not True:
            raise AssertionError(f"the bf16 forward at batch {batch} is not finite")

    # bf16 against f32 on the lab's weights and inputs at batch 16
    batch, l, s = batches[0], LAB["views"], LAB["size"]
    rng = np.random.default_rng(0)
    lrs = torch.from_numpy(rng.random((batch, l, s, s), dtype=np.float32)).cuda()
    alphas = torch.ones((batch, l), device="cuda")
    srs = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            model = HRNet(DEFAULT_CONFIG["network"], device="cuda", dtype=dtype,
                          generator=torch.Generator().manual_seed(0)).eval()
            srs[dtype] = model(lrs, alphas).double()
    sr32, err = srs[torch.float32], srs[torch.bfloat16] - srs[torch.float32]
    for how, scale in (("on [0.1, 0.9]", 0.8 / (sr32.max() - sr32.min()).item()),
                       ("relative to max|f32|", 1 / sr32.abs().max().item())):
        rms = err.square().mean().sqrt().item() * scale
        mx = err.abs().max().item() * scale
        print(f"[lab4] bf16 vs f32 forward, batch {batch}, {how}: rms {rms:.4e} (limit "
              f"{BF16_RMS}), max {mx:.4e} (limit {BF16_MAX})")
        if not (rms < BF16_RMS and mx < BF16_MAX):
            raise AssertionError(f"the bf16 forward leaves the bf16 envelope ({how})")
    return counts


def phase_fills(fusion, fusion_dma, lanczos_fused) -> None:
    """Each wrapper, run once under torch.profiler with deterministic
    algorithms on, launches its kernel and nothing else (no NaN fill); the
    forward of LanczosShift is that one kernel too. Then, at each kernel's
    timed output shape, the fill's device time and the host time of
    torch.empty against empty_output; each wrapper's host time per call."""
    from highresnet_tpu_torch.kernels.alloc import empty_output

    if not torch.are_deterministic_algorithms_enabled():
        raise AssertionError("setup_device left deterministic algorithms off")
    control = device_ops(lambda: torch.empty((8, 1024), device="cuda"))
    if not any("fill" in name.lower() for name in control):
        raise AssertionError(f"torch.empty launched no fill ({control}): the check cannot see one")
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((8, TRAIN["views"], 64, 64, 64), generator=g, device="cuda")
    cot = torch.randn((8, TRAIN["views"] // 2, 128, 64, 64), generator=g, device="cuda")
    img = torch.rand((8, 192, 192), generator=g, device="cuda", requires_grad=True)
    shift = (torch.rand((8, 2), generator=g, device="cuda") * 6 - 3).requires_grad_()
    wrappers = {
        "K1 pack_pairs_cuda": (lambda: fusion.pack_pairs_cuda(x), "pack_pairs"),
        "K2 unpack_pairs_cuda": (lambda: fusion.unpack_pairs_cuda(cot, TRAIN["views"]), "unpack_pairs"),
        "K3 lanczos_shift_cuda": (lambda: lanczos_fused.lanczos_shift_cuda(img.detach(), shift.detach()),
                                  "lanczos_shift"),
        "K3 LanczosShift.apply forward": (lambda: lanczos_fused.LanczosShift.apply(img, shift),
                                          "lanczos_shift"),
        "K4 pack_pairs_dma_cuda": (lambda: fusion_dma.pack_pairs_dma_cuda(x), "pack_pairs_dma"),
    }
    for what, (fn, kernel) in wrappers.items():
        ops = device_ops(fn)
        print(f"[fills] {what}: device operations {[name[:80] for name in ops]} (torch.empty "
              f"alone launches {control[0][:80]!r})")
        if len(ops) != 1 or f"{kernel}_kernel" not in ops[0]:
            raise AssertionError(f"{what} launched {ops}, not its kernel alone")

    # what the fill cost each wrapper at its timed shape: torch.empty of the output
    b, l, s = HEADLINE["batch"], HEADLINE["views"], HEADLINE["size"]
    outputs = {"K1 (8, 8, 128, 128, 128) f32": ((b, l // 2, 128, s, s), torch.float32),
               "K2 (8, 8, 64, 64, 64) f32": ((8, TRAIN["views"], 64, 64, 64), torch.float32),
               "K3 (8, 192, 192) f32": ((8, 192, 192), torch.float32),
               "K4 (8, 8, 128, 128, 128) bf16": ((b, l // 2, 128, s, s), torch.bfloat16)}
    ms = graph_times_ms({what: (lambda shape=shape, dtype=dtype: torch.empty(
        shape, dtype=dtype, device="cuda")) for what, (shape, dtype) in outputs.items()})
    print("[fills] torch.empty of each timed output under deterministic algorithms, the fill "
          f"the wrapper no longer launches (device time per call, CUDA graph of {GRAPH_CALLS} "
          f"calls, median of {GRAPH_REPLAYS} replays): " + ", ".join(
              f"{what} {t:.4f} ms" for what, t in ms.items()))
    # and what each allocation costs the host, the fill's launch included
    allocs = {"torch.empty": lambda shape, dtype: torch.empty(shape, dtype=dtype, device="cuda"),
              "empty_output": lambda shape, dtype: empty_output(shape, dtype, "cuda")}
    parts = []
    for what, (shape, dtype) in outputs.items():
        us = {name: host_us(lambda: alloc(shape, dtype)) for name, alloc in allocs.items()}
        parts.append(f"{what} " + " vs ".join(f"{name} {t:.2f} us" for name, t in us.items()))
    print(f"[fills] host time per allocation of each timed output (CPU clock, median of "
          f"{HOST_CALLS} calls, the card drained between calls): " + "; ".join(parts))
    print("[fills] host time per wrapper call, the same timer (K1, K4 on (8, 8, 64, 64, 64) f32, "
          "K2 on (8, 4, 128, 64, 64) f32, K3 on (8, 192, 192) f32): " + ", ".join(
              f"{what} {host_us(fn):.2f} us" for what, (fn, _) in wrappers.items()))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this script needs one NVIDIA GPU")
    from highresnet_tpu_torch.kernels import build
    from highresnet_tpu_torch.ops import fusion, fusion_dma, lanczos_fused
    from highresnet_tpu_torch.runtime import card_line, setup_device

    card = card_line()
    print(card)
    print(f"[setup] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    setup_device("cuda")

    path = build.library_path()
    cached = path.is_file()
    t0 = time.perf_counter()
    build.load()
    how = "cached" if cached else f"built and loaded in {time.perf_counter() - t0:.1f} s"
    print(f"[build] {os.path.relpath(path, REPO)} {how}")

    measured = {
        "pack": phase_pack(fusion),
        "unpack": phase_unpack(fusion, card),
        "lanczos": phase_warp(lanczos_fused, card),
    }
    predicted = phase_predict(fusion, lanczos_fused, card)
    phase_forward(card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        trained = phase_train(fusion, lanczos_fused, card, tmp)
        phase_train_step(card, tmp)
    dma = phase_dma(fusion, fusion_dma, card)
    measured["pack"].update(dma["pack"])
    measured["pack_dma"] = dma["pack_dma"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lab4_") as tmp:
        lab = phase_lab4(fusion, lanczos_fused, card, tmp)
    phase_fills(fusion, fusion_dma, lanczos_fused)

    sources = {
        "pack": ("pack_pairs", "pack_pairs.cu", "highresnet_tpu/ops/fusion_pallas.py:46"),
        "unpack": ("unpack_pairs", "unpack_pairs.cu", "highresnet_tpu/ops/fusion_pallas.py:104"),
        "lanczos": ("lanczos_shift", "lanczos_shift.cu", "highresnet_tpu/ops/lanczos_pallas.py:39"),
        "pack_dma": ("pack_pairs_dma", "pack_pairs_dma.cu", "examples/fusion_lab4.py:64"),
    }
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": f"highresnet_tpu_torch/csrc/{src}",
        "replaces": replaces,
        "launches": predicted[key] + trained[key] + lab[key],
        **measured[key],
    } for key, (name, src, replaces) in sources.items()]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
