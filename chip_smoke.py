"""Drive the PyTorch port's serving and training paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints lines; any failure raises, so the exit code is not 0):
  1. card name and power limit (nvidia-smi), torch/CUDA versions, device setup;
  2. build the CUDA kernels from ``highresnet_tpu_torch/csrc``;
  3. [pack] the pair-pack kernel (K1) against its plain PyTorch version:
     ``torch.equal`` at the headline shape, at every fusion round of the
     flagship's training step (batch 32, 32 px), validation forward (batch
     4, 128 px) and served scene (batch 1, 128 px), at every fusion round
     of the bench's rows (the train steps at batch 32 x 32 views x 64 px,
     the 32-view rows at batch 4 and 1, the batch-32 16-view forward), and
     at odd shapes, each in f32 and bf16 (K1 is timed in [dma]);
  4. [unpack] the unpack kernel (K2) the same way at the first-round training
     shape, at every round's cotangent of the flagship step's backward
     (32, L/2, 128, 32, 32), at every round's cotangent of the bench's
     train steps (32, L/2, 128, 64, 64), L = 32 down to 2, in f32 and
     bf16, and at odd view counts, then gradients through ``PackPairs`` on
     the card against the CPU plain version's autograd, bit for bit; K2
     timed in turns with K1 on a pack that moves the same bytes, the plain
     version and ``index_select``;
  5. [warp] the Lanczos warp kernel (K3, taps computed inside it) against
     its plain version (limit 1e-5) at the training shape and two odd
     shapes, zero shift, gradients of ``LanczosShift`` against the plain
     autograd, the in-kernel taps against ``lanczos_kernel``, and K3 and the
     plain version (taps included) timed; then K3 at the serving shapes
     (7, 384, 384) (x8 TTA's alignment of one scene) and (1, 384, 384)
     (registered scoring), checked and timed the same way;
  5b. [trmisr] TR-MISR's attention kernel (K5) against ``attend_ref`` at the
     ``trmisr-archive`` shape (8 scenes x 128 x 128 pixels, 17 tokens, 8
     heads of 64, 9-16 real views a scene) within 1e-6 of max |ref|, its
     output in a NaN-filled block, and at small shapes over every head
     width it is built for and 1, 6 and 32 tokens; gradients through
     ``Attend`` equal to the plain version's; K5, the plain version and
     SDPA's memory-efficient backend (a scene a call) timed at the cell's
     shape; then ``Model.forward`` at configs/trmisr.json's full width on a
     batch of 8 16-view 128 px scenes: 6 launches of K5 (one a block), a
     finite SR, ms a batch;
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
     predict CLI; the seed-0 train state (flax's lecun-normal init) drawn for
     the card equal to the CPU's bit for bit; one step on the GPU against the
     port's CPU path (dropout off); the train step timed with the kernels and
     with the plain versions.
     The predict and train runs launch K4 no time.
  8b. [dist] data parallelism through ``train_and_get_best_model`` at the
     same width on its own deterministic 8-view 64 px set (all views in
     clearance order, whole frames, no shuffle; 2 epochs, eval batch 2):
     one process at batch 8 first, then two ranks on the one card over
     Gloo (this script's hidden ``--dist-rank`` mode, HRN_COORDINATOR), each
     on its shard at 4 scenes a step, at configs/config.json's lr: against
     the one process, each step and epoch before its ShiftNet leaves the
     warp's ±3 px window (``held_epochs``) with loss within 1e-4, val
     within 1e-3 and grad_norm within 1e-3, or NOISE_FACTOR times the noise
     floor (the one-process run with cuDNN off against itself with it on,
     measured in the same call) where that is larger; later epochs printed,
     not held; final weights
     bit-identical on both ranks, rank 0 alone writing the run directory,
     K1/K2/K3 launches summed over the ranks against the count the steps
     and val forwards imply, ms per step of both (two ranks time-sharing
     one card is not a scaling figure); then ``cli.train`` under
     HRN_COORDINATOR with NCCL, one rank per visible card, its printed
     loss and val against one process at the same global batch. Any rank's
     failure or timeout fails the phase.
  8c. [view] the 2-D layout (``training.mesh``) through
     ``train_and_get_best_model`` on [dist]'s config and set: {"data": 1,
     "view": 2} on two Gloo ranks and {"data": 2, "view": 2} on four, all
     sharing the one card, each against one process at the same global
     batch (the replicas' shards interleaved; at data 2 [dist]'s own run):
     the steps and epochs before the warp window is left held as [dist]
     holds them (at data 2 against [dist]'s one process and floor), final
     weights bit-identical on every rank, rank 0 alone writing, each rank's
     K1/K2/K3 launches
     against the count the fusion rounds imply (every rank packs once a
     round, its own block of pairs on a sharded round); ms per step, the
     fusion states gathered over the view group per step, peak memory per
     rank, the phase's wall time; then ``cli.train`` on the layout with
     NCCL over pairs of cards when there are two or more (on one card it
     says the leg did not run).
  8d. [options] the loop's four options through ``cli.train`` at the tiny
     width of tests/test_torch_loop_options.py (8 channels, 4 views of 24
     px, batch 2, register 32, EMA on, every step registered through the
     fused warp, 2 epochs) on a misaligned synthetic set without norm.csv,
     each on the card and on the port's CPU path: ``cache_val_batches``
     false, ``grad_clip_norm`` at the CPU run's median first-epoch
     grad_norm (binding on some steps and not others on both), ``val_views``
     [2, 1], and ``early_stop_patience`` 1 at lr 0 (stopped at epoch 2,
     best epoch 1) relaunched with more epochs (one epoch run, stopped at
     3): each step's loss within 1e-4 and grad_norm within 1e-3 of the
     CPU's, each epoch's score within 0.01 dB, the epochs and best epoch
     equal; each card run's K1/K2/K3 launches against the count its steps
     and val forwards imply; the phase within 40 s.
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
 12. [flagship] the measured-best recipe (configs/flagship.json,
     flagship_ft_rp.json, flagship_ft_varl.json at full width: batch 32, 16
     views, 32 px patches, register 64, warp_int_range 4) on a synthetic
     misaligned 16-view 128 px set, the cuts printed (data, epochs 2/1/1,
     register_warmup_epochs 1): the 400-step ShiftNet warm-start twice from
     one seed (bit-identical, RMSE, ms per step, no kernel launched), its
     fused-warp branch (warp_int_range 0, use_pallas_warp) for 20 steps with
     K3 once per step and its pairs against the plain warp's, the
     three stages chained through ``cli.train --run-dir`` (K1 and K2 launches
     against the steps and val forwards), stage 1's train step on the GPU
     against the port's CPU path, then ``cli.predict`` on the last
     stage plain, ``--tta 8``, ``--registered``, with two checkpoints and
     with ``--top-k 1`` (the bicubic route), each with its launches per
     scene (K3 once per scene on the aligned and registered paths); the
     registered train step of stage 1 timed; ms per scene of each serving
     path and x8 TTA's alignment alone; one val scene under ``--tta 8`` and
     ``--registered`` on the GPU against the port's CPU path.
 12b. [examples] every driver of ``highresnet_tpu_torch/examples/`` through
     its own ``main`` at a smoke protocol (one synthetic misaligned set of
     12 scenes, 8 views of 48 px, made once; 1 epoch a run, batch 8; the
     production widths, ShiftNet at register_size 2·patch; the cuts
     printed): each driver's K1/K2/K3 launches counted from 0, asserted
     non-zero where the driver runs the kernel, TF32 off after each; the
     scoring legs (MFSR/one view/bicubic, the views sweep, the TTA arms,
     frac_cpsnr) on the card against the port's CPU path on the same
     weights within 0.01 dB per scene; K3 at frac_cpsnr's (625, 144, 144)
     against its plain version (limit 1e-5) and timed as in [warp]; each
     driver's seconds and summary on a line of its own.
 13. [registration] the registration toolkit on a seeded smooth 384 px
     field (the HR frame size) with a cloud blob and a 4 px border masked,
     its template shifted by a known (0.7, -0.4) px (scipy, order 3), and a
     broadband pair with an exact Fourier shift for PCC; seeded VGG19
     weights: ``RegistrationSession(device="cuda")`` solves with each of the
     seven methods at the JAX defaults (7 points, 10 levels; ORB at scale
     2), each shift held to its limit; the same calls on the port's CPU
     path (Perceptual Loss at 64 px, 3 points, 3 levels) agree within
     0.01 px, and the metrics both record at the GPU's shift within 1e-4
     relative; the MI histogram
     under deterministic algorithms (GPU counts equal to the CPU's);
     record_metrics, vote, the nine overlays and the VGG diff heatmap, the
     session's tensors on the card; ``preprocess_imgset`` on a synthetic
     16-view scene (GPU against CPU, files written); ms per
     ``compute_and_apply_shift`` of each method, per grid level of NCC and
     PL, and ``features_batched`` over 49 x 384 px with its peak memory.
     No launch of K1-K4 (asserted).
 14. [bench] ``highresnet_tpu_torch.bench.main`` in-process, every row of the
     bench at its full shape (the headline, bf16 headline, the f32 and bf16
     train steps at batch 32 x 32 views x 64 px, the eval step, 32-view f32,
     batch-32 bf16, batch-1 latency) with a window of two calls and one
     repeat: every row present, finite and positive, none still
     ``timing_suspect``, the bench's four-key line, the bf16 train step's
     parameters, gradients and Adam moments f32, each row's K1/K2 launches
     as its calls imply and no K3 or K4, the phase within 150 s; each row
     printed beside the card line.
 15. [labs] the five perf labs of ``highresnet_tpu_torch/labs/`` through their
     own ``main`` at the JAX labs' default shapes with short windows:
     fusion_lab in f32 and bf16 (every ``*_max_abs_diff`` within 1e-4 of its
     control's largest magnitude in f32 with TF32 off, within the bf16
     envelope's 1.5e-2 in bf16), fusion_lab2 and fusion_lab3 in bf16
     (v3_flat likewise; the lab's own ``pack_equal``, then K1 at the lab's
     pack shape ``torch.equal`` to ``pack_pairs_ref`` in a NaN-filled
     block), bench_breakdown in f32 and bf16, and trace_train_step on the
     bench's train rows (batch 32 x 32 views x 64 px) in f32 and bf16 with
     2 traced steps: its categories summing to its device total within 1%,
     the port's kernels among them, its device ms a step within 10% of
     [bench]'s window for that row. Each
     lab's K1/K2 launches as its calls imply (K2 only in the trace's
     backward), no K3 or K4; every lab key printed beside the card line.
Each bit-exact or tolerance check of K1-K4 reads an output that the kernel
wrote into a block just filled with NaN and freed (``poison``), so a byte
the kernel leaves unwritten shows. Kernel times: ``ms`` is device time per
call, from a CUDA graph of 20 back-to-back calls replayed between two
events (median of 10 replays); ``call_ms`` is one call between two events,
the wrapper's host part included (median of 20), the series of the earlier
runs. ``plain_ms`` and ``library_ms`` use the graph timer too.
Then one JSON line with the kernels (``launches`` sums the predict, train,
dist (both ranks), view (every rank), options, lab, flagship, examples, bench and
labs runs,
the fused warm-start included; K3's entry also holds its serving shapes and
frac_cpsnr's; K5's counts [trmisr]'s ``Model.forward`` alone, the one run of
TR-MISR here;
``bound_ms`` is the least time the card could take for the timed call,
from its bytes at 3.35 TB/s and its operations at the peak rate of their
type; ``library_ms`` is one PyTorch call computing the same function, or
null), the card line again, and last the device JSON line.
Needs CUDA; it imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import glob
import io
import json
import math
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
SERVING_WARPS = ((7, 384, 384), (1, 384, 384))  # K3 on the serving paths (one 384 px scene)
# the measured-best recipe (configs/flagship*.json) on a misaligned synthetic
# set: 36 scenes give 32 train scenes (one batch of 32) and 4 val scenes
FLAGSHIP = dict(views=16, size=128, scenes_per_channel=18, hr_shift_sigma=1.25,
                epochs={"flagship": 2, "flagship_ft_rp": 1, "flagship_ft_varl": 1},
                register_warmup_epochs=1)
# (batch, px) of the flagship's forwards, 64 channels into the fusion: a
# training step on 32 px patches, a validation forward (eval_batch_size 4)
# and a served scene on whole 128 px views
FLAGSHIP_FORWARDS = ((32, 32), (4, 128), (1, 128))
FUSED_WARMUP_STEPS = 20  # the warm-start's fused-warp branch, driven at warp_int_range 0
SERVE_REPS = 3  # ms per scene: median over the val scenes, each served this many times
GRAPH_CALLS, GRAPH_REPLAYS = 20, 10  # kernel times: calls per CUDA graph, replays timed
HOST_CALLS = 200  # host time of an allocation: calls timed
TRMISR = dict(batch=8, views=16, size=128, heads=8, head_dim=64)  # the trmisr-archive cell
ATTEND_RTOL = 1e-6  # K5 vs attend_ref: max |diff| / max |ref|, the same f32 sums in other orders
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


def fusion_rounds(batch: int, views: int, channels: int, size: int) -> list[tuple]:
    """The (B, L, C, H, W) pack inputs of every fusion round of one forward."""
    shapes = []
    while views >= 2:
        shapes.append((batch, views, channels, size, size))
        views //= 2
    return shapes


def bench_rows(kind: str | None = None) -> list:
    """The bench's rows (of one kind): their (batch, views, px) are the
    shapes its forwards and train steps give K1 and K2 at 64 channels."""
    from highresnet_tpu_torch.bench import ROWS

    return [row for row in ROWS if kind in (None, row.kind)]


def phase_pack(fusion) -> dict:
    """K1 against pack_pairs_ref: bit-exact at the headline, at every fusion
    round of the flagship's training, validation and serving forwards and of
    the bench's rows, and at odd shapes, its output in a NaN-filled block
    (timed in [dma])."""
    g = torch.Generator(device="cuda").manual_seed(0)
    b, l, s = HEADLINE["batch"], HEADLINE["views"], HEADLINE["size"]
    flagship = [shape for batch, size in FLAGSHIP_FORWARDS
                for shape in fusion_rounds(batch, FLAGSHIP["views"], 64, size)]
    benched = [shape for row in bench_rows()
               for shape in fusion_rounds(row.batch, row.views, 64, row.size)]
    shapes = list(dict.fromkeys([(b, l, 64, s, s), *flagship, *benched, (2, 5, 3, 7, 5),
                                 (3, 5, 1, 3, 3), (1, 3, 5, 5, 5)]))
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
    # the flagship step's backward: every round's cotangent (32, L/2, 128, 32, 32)
    fb, fs = FLAGSHIP_FORWARDS[0]
    flagship = [((fb, l, 2 * c, h, w), torch.float32)
                for _, l, c, h, w in fusion_rounds(fb, FLAGSHIP["views"], 64, fs)]
    # the bench's train steps' backward, f32 and bf16: (32, L/2, 128, 64, 64)
    benched = list(dict.fromkeys(
        ((b, l, 2 * c, h, w), dtype) for row in bench_rows("train_step")
        for b, l, c, h, w in fusion_rounds(row.batch, row.views, 64, row.size)
        for dtype in (torch.float32, torch.bfloat16)))
    cases = [(first_round, torch.float32), (first_round, torch.bfloat16), *flagship,
             ((fb, FLAGSHIP["views"], 128, fs, fs), torch.bfloat16), *benched,
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
    serving = {}
    for shape in SERVING_WARPS:  # TTA x8's alignment of one scene, registered scoring
        img = torch.rand(shape, generator=g, device="cuda")
        shift = torch.rand((shape[0], 2), generator=g, device="cuda") * 6 - 3
        address = poison(shape, torch.float32)
        got = lanczos_fused.lanczos_shift_cuda(img, shift)
        check_poisoned(got, address, f"lanczos_shift_cuda at {shape}")
        err = (got - lanczos_fused.lanczos_shift_ref(img, shift)).abs().max().item()
        max_err = max(max_err, err)
        if not err <= WARP_ATOL:
            raise AssertionError(f"lanczos kernel disagrees with its plain version at {shape}")
        t = graph_times_ms({"K3": lambda: lanczos_fused.lanczos_shift_cuda(img, shift),
                            "plain": lambda: lanczos_fused.lanczos_shift_ref(img, shift)})
        s_moved = 2 * img.numel() * img.element_size() + shift.numel() * shift.element_size()
        s_flops = 2 * 2 * 7 * img.numel()
        s_bound = bound_ms(s_moved, s_flops)
        s_by = "bytes" if s_moved / HBM_BYTES_PER_S >= s_flops / F32_FLOPS else "operations"
        print(f"[warp] serving shape {shape} f32, shifts in ±3 px, output in a NaN-filled block: "
              f"max|kernel - plain| {err:.3e} (limit {WARP_ATOL}); device time per call (CUDA "
              f"graph of {GRAPH_CALLS} calls, median of {GRAPH_REPLAYS} replays, in turns) K3 "
              f"{t['K3']:.4f} ms, plain {t['plain']:.4f} ms; bound {s_bound * 1e3:.3f} us "
              f"({s_moved / 1e6:.2f} MB; {s_by}, {s_bound / t['K3']:.1%} of it); {card}")
        serving[str(shape)] = {"max_abs_err": err, "ms": t["K3"], "plain_ms": t["plain"],
                               "bound_ms": s_bound, "bound_by": s_by}
    return {"max_abs_err": max_err, "ms": ms["K3"], "call_ms": call_ms, "plain_ms": ms["plain"],
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None, "serving": serving}


def attend_inputs(g: torch.Generator, b: int, p: int, n: int, heads: int, d: int):
    """qkv (b, p, n, 3·heads·d) and the key bias (b, n) of scenes with
    1 + (n - 1) // 2 to n - 1 real views (9 to 16 at n 17, as the cell's
    traffic); token 0 always counts."""
    qkv = torch.randn(b, p, n, 3 * heads * d, generator=g, device="cuda")
    real = torch.randint(min(1 + (n - 1) // 2, n - 1), n, (b, 1), generator=g, device="cuda")
    ok = torch.arange(n, device="cuda")[None, :] <= real
    return qkv, torch.zeros(b, n, device="cuda").masked_fill(~ok, -math.inf)


def sdpa_attend(qkv: torch.Tensor, key_bias: torch.Tensor, heads: int) -> torch.Tensor:
    """The same function through SDPA's memory-efficient backend, a scene a
    call (its flash backend takes no float32)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    b, p, n, _ = qkv.shape
    q, k, v = (t.transpose(-2, -3) for t in qkv.unflatten(-1, (3, heads, -1)).unbind(-3))
    outs = []
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        for i in range(b):
            mask = key_bias[i].expand(p, heads, n, n).contiguous()
            outs.append(F.scaled_dot_product_attention(q[i], k[i], v[i], attn_mask=mask))
    return torch.stack(outs).transpose(-2, -3).flatten(-2)


def attend_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


def phase_trmisr(card: str) -> dict:
    """K5 against attend_ref at the trmisr-archive shape and at small ones,
    its output in a NaN-filled block; Attend's gradient; K5, the plain version
    and SDPA timed at the cell's shape; Model.forward at full width with K5
    once a block."""
    from highresnet_tpu_torch import load_config
    from highresnet_tpu_torch.eval.evaluator import Model
    from highresnet_tpu_torch.models.network import build_network
    from highresnet_tpu_torch.ops import attention

    g = torch.Generator(device="cuda").manual_seed(31)
    b, p, n, heads, d = (TRMISR["batch"], TRMISR["size"] ** 2, TRMISR["views"] + 1,
                         TRMISR["heads"], TRMISR["head_dim"])
    cases = [(b, p, n, heads, d)] + [(2, 300, t, 3, w) for w in attention.HEAD_DIMS
                                     for t in (1, 6, 17, attention.MAX_TOKENS)]
    worst = 0.0
    for shape in cases:
        qkv, bias = attend_inputs(g, *shape[:3], *shape[3:])
        address = poison((*shape[:3], shape[3] * shape[4]), torch.float32)
        got = attention.attend_cuda(qkv, bias, shape[3])
        check_poisoned(got, address, f"attend_cuda at {shape}")
        gap = attend_gap(got, attention.attend_ref(qkv, bias, shape[3]))
        if not gap < ATTEND_RTOL:
            raise AssertionError(f"attend_cuda at {shape}: max |K5 - plain| / max |plain| {gap:.3g}")
        worst = max(worst, gap)
        print(f"[trmisr] K5 against attend_ref at (B, P, n, h, d) {shape}, output in a "
              f"NaN-filled block: max |diff| / max |ref| {gap:.3g} (limit {ATTEND_RTOL:g})")
        del qkv, got
    torch.cuda.empty_cache()

    qkv, bias = attend_inputs(g, 2, 300, n, heads, d)
    x = qkv.clone().requires_grad_()
    cot = torch.randn((2, 300, n, heads * d), generator=g, device="cuda")
    (got,) = torch.autograd.grad(attention.attend(x, bias, heads), x, cot)
    (want,) = torch.autograd.grad(attention.attend_ref(x, bias, heads), x, cot)
    if not torch.equal(got, want):
        raise AssertionError("Attend's backward differs from the plain version's gradient")
    print("[trmisr] Attend gradient on the card == attend_ref's autograd: True")

    qkv, bias = attend_inputs(g, b, p, n, heads, d)
    moved = 4 * b * p * n * heads * d * 4  # q, k and v read, the heads' output written
    flops = 4 * b * p * heads * n * n * d  # q kᵀ and w v
    before = attention.LAUNCHES
    with torch.inference_mode():
        ms = graph_times_ms({"K5": lambda: attention.attend_cuda(qkv, bias, heads)}, calls=2)
        ms.update(graph_times_ms({"plain": lambda: attention.attend_ref(qkv, bias, heads)},
                                 calls=1, replays=5))
        torch.cuda.empty_cache()
        ms.update(graph_times_ms({"sdpa_mem_efficient": lambda: sdpa_attend(qkv, bias, heads)},
                                 calls=1, replays=5))
        torch.cuda.empty_cache()
        call_ms = statistics.median(cuda_times_ms(lambda: attention.attend_cuda(qkv, bias, heads),
                                                  10, 2))
    attention.LAUNCHES = before
    bound = bound_ms(moved, flops)
    print(f"[trmisr] attention at (B, P, n, h, d) {(b, p, n, heads, d)} f32, {moved / 1e9:.2f} GB "
          f"moved, {flops / 1e9:.1f} GFLOP; device time per call (CUDA graph, median of replays): "
          + ", ".join(f"{name} {t:.4f} ms ({bound / t:.1%} of the bound)" for name, t in ms.items())
          + f"; K5 one call with its host part {call_ms:.4f} ms (median of 10); bound "
          f"{bound:.4f} ms; {card}")
    del qkv, bias
    torch.cuda.empty_cache()

    config = load_config(str(REPO / "configs" / "trmisr.json"))
    model = Model(config, "cuda")
    model.set_params(build_network(config, "cpu", torch.Generator().manual_seed(31)).state_dict())
    rng = np.random.default_rng(31)
    lrs = rng.random((b, TRMISR["views"], TRMISR["size"], TRMISR["size"]), dtype=np.float32)
    alphas = np.ones((b, TRMISR["views"]), dtype=np.float32)
    alphas[:, 12:] = 0
    model.forward(lrs, alphas)  # warm-up
    attention.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sr = model.forward(lrs, alphas)
    forward_ms = (time.perf_counter() - t0) * 1e3
    launches = attention.LAUNCHES
    depth = config["network"]["transformer"]["depth"]
    if launches != depth or not np.isfinite(sr).all():
        raise AssertionError(f"[trmisr] Model.forward: {launches} K5 launches (want {depth}), "
                             f"finite SR {np.isfinite(sr).all()}")
    print(f"[trmisr] Model.forward TR-MISR f32 batch {b} x {TRMISR['views']} views x "
          f"{TRMISR['size']}px, 12 real: {launches} K5 launches, SR {sr.shape} finite, "
          f"{forward_ms:.1f} ms (host clock, numpy in and out); {card}")
    del model
    torch.cuda.empty_cache()
    return {"max_rel_err": worst, "ms": ms["K5"], "call_ms": call_ms, "plain_ms": ms["plain"],
            "bound_ms": bound, "bound_by": "bytes" if moved / HBM_BYTES_PER_S > flops / F32_FLOPS
            else "flops", "library_ms": ms["sdpa_mem_efficient"], "launches": launches}


def phase_predict(fusion, lanczos_fused, card: str) -> dict:
    """The predict CLI end to end; returns the kernel launch counts in it."""
    from highresnet_tpu_torch import load_config
    from highresnet_tpu_torch.cli import predict
    from highresnet_tpu_torch.data import collate, make_synthetic_dataset
    from highresnet_tpu_torch.eval.evaluator import Model, load_data
    from highresnet_tpu_torch.models.convert import WEIGHTS_NAME
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
        torch.save(model.state_dict(), os.path.join(run_dir, WEIGHTS_NAME))

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


def init_gpu_vs_cpu(cfg: dict, tag: str) -> None:
    """The train state drawn from seed 0 on the card and on the CPU: both
    models (flax's init: lecun-normal kernels, zero biases, drawn on the CPU
    and moved) equal bit for bit."""
    from highresnet_tpu_torch.train.state import create_train_state

    states = {d: create_train_state(cfg, d, torch.Generator().manual_seed(0))
              for d in ("cuda", "cpu")}
    tensors = elements = 0
    for name in ("hrnet", "shiftnet"):
        gpu = getattr(states["cuda"], name).state_dict()
        cpu = getattr(states["cpu"], name).state_dict()
        if gpu.keys() != cpu.keys() or not all(torch.equal(gpu[k].cpu(), cpu[k]) for k in cpu):
            raise AssertionError(f"[{tag}] the seed-0 {name} differs between the card and the CPU")
        tensors += len(cpu)
        elements += sum(v.numel() for v in cpu.values())
    kernel = states["cpu"].hrnet.encode.res_layers[0].block[0].weight
    print(f"[{tag}] seed-0 init (lecun-normal kernels, zero biases), GPU vs CPU: {tensors} "
          f"tensors, {elements} elements, equal bit for bit (a 64->64 conv kernel's std "
          f"{kernel.std().item():.5f}, flax's sqrt(1/576) = {math.sqrt(1 / 576):.5f})")


def step_gpu_vs_cpu(cfg: dict, batch, tag: str) -> None:
    """One train step from one init and batch on the GPU and on the port's
    CPU path, dropout off: the loss and the gradient norm within their limits."""
    metrics = {}
    for device in ("cuda", "cpu"):
        state, step, args = _step_pieces(cfg, device, batch)
        _, m = step(state, *args)
        metrics[device] = {k: v.item() for k, v in m.items()}
    d_loss = abs(metrics["cuda"]["loss"] - metrics["cpu"]["loss"]) / abs(metrics["cpu"]["loss"])
    d_norm = abs(metrics["cuda"]["grad_norm"] - metrics["cpu"]["grad_norm"]) / metrics["cpu"]["grad_norm"]
    print(f"[{tag}] one step, batch {tuple(batch.lrs.shape)}, GPU vs CPU port, dropout off: loss "
          f"{metrics['cuda']['loss']:.7f} vs {metrics['cpu']['loss']:.7f} (rel {d_loss:.2e}, limit "
          f"{STEP_LOSS_RTOL}), grad_norm {metrics['cuda']['grad_norm']:.7f} vs "
          f"{metrics['cpu']['grad_norm']:.7f} (rel {d_norm:.2e}, limit {STEP_GRAD_NORM_RTOL})")
    if d_loss > STEP_LOSS_RTOL or d_norm > STEP_GRAD_NORM_RTOL:
        raise AssertionError(f"[{tag}] GPU and CPU train steps of the port disagree")


def phase_train_step(card: str, tmp: str) -> None:
    """One step from one init and batch on the GPU and on the port's CPU
    path; then the step timed with the kernels and with the plain versions."""
    from highresnet_tpu_torch.data import discover_scenes
    from highresnet_tpu_torch.train.setup import build_train_loader

    with open(os.path.join(tmp, "config.json")) as f:
        cfg = json.load(f)
    t = cfg["training"]
    scenes = discover_scenes(os.path.join(cfg["paths"]["prefix"], "train"))
    batch = next(iter(build_train_loader(t, scenes, seed=0, data_dir=cfg["paths"]["prefix"])))
    init_gpu_vs_cpu(cfg, "train")
    step_gpu_vs_cpu(cfg, batch, "train")

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


# [dist]: configs/config.json's width and shapes (batch 8, 8 views, 64 px
# inputs, register 128, fused warp) on its own synthetic set of 8-view 64 px
# scenes (16 train, 2 val), 2 epochs. Sampling is deterministic, as in the
# JAX multi-host test (tests/test_multihost.py): every view in clearance
# order (n_views -1), whole frames as the 64 px patches, no shuffle, so the
# ranks' global batches are the one process's batches row for row; two
# ranks on one card over Gloo hold 4 scenes a step each
DIST = dict(world=2, epochs=2, eval_batch_size=2, views=8, size=64, scenes_per_channel=9)
DIST_TIMEOUT_S = 300  # each rank process; a rank that dies fails the phase within it
# val score, ranks against one process: Adam's first steps move a parameter
# whose gradient is zero in exact arithmetic (HRNet's output bias under the
# bias-corrected loss) by about ±lr from reduction-order noise, which differs
# between batch 4 and 8 on the card; eval clips the SR to [0, 1], so that
# offset moves the val score (5.45e-04 at epoch 2 in the first card run,
# where the loss, invariant to it, stayed within 1e-4)
DIST_VAL_RTOL = 1e-3
# [dist] and [view]: the first steps of a layout agree with one process to
# 1e-7 (loss) and 4e-6 (grad_norm). At the config's lr ShiftNet leaves the
# warp's ±3 px window at step 3 (6.01 px from flax's init; a grad_norm spike
# of 1194 against 131-178 before it, H100, 700 W), and past it two runs that
# differ by rounding alone part by more than the limits above: the epoch-2
# val of two ranks read 4.48e-02 from one process where the one-process run
# with cuDNN off read 3.69e-03 from itself with cuDNN on. So the epochs
# before the window is left are held, to the limits above or NOISE_FACTOR
# times that floor, measured in the same call, where it is larger (the
# epoch-1 val: ranks 1.39e-03, floor 6.34e-04, the output bias's ±lr steps
# moving the clipped val); later epochs are printed
NOISE_FACTOR = 4.0


def dist_config(tmp: str, run_name: str) -> tuple[dict, str]:
    """configs/config.json for [dist] on its synthetic set (built once)."""
    from highresnet_tpu_torch import load_config
    from highresnet_tpu_torch.data import make_synthetic_dataset

    root = os.path.join(tmp, "dist_data")
    if not os.path.isdir(root):
        make_synthetic_dataset(root, n_scenes_per_channel=DIST["scenes_per_channel"],
                               n_views=DIST["views"], lr_size=DIST["size"], seed=0,
                               splits=("train",))
    cfg = load_config(str(REPO / "configs" / "config.json"))
    cfg["paths"].update(prefix=root, checkpoint_dir=os.path.join(tmp, run_name),
                        tb_log_file_dir="")
    cfg["training"].update(
        min_L=DIST["views"], n_views=-1, create_patches=False, patch_size=DIST["size"],
        shuffle=False, use_pallas_warp=True, num_epochs=DIST["epochs"],
        eval_batch_size=DIST["eval_batch_size"],
    )
    path = os.path.join(tmp, f"{run_name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return cfg, path


def recorded_train(cfg: dict, run_dir: str, device: str) -> dict:
    """``train_and_get_best_model`` with its steps, epochs, final state and
    file writes recorded (the kernel launch counts read around it)."""
    from highresnet_tpu_torch.parallel import distributed
    from highresnet_tpu_torch.train import checkpoint, loop, setup

    steps, epochs, states, writes = [], [], [], []
    real_epoch, real_atomic, real_build = loop.run_train_epoch, checkpoint._atomic, \
        setup.build_train_step

    def epoch(loader, state, *args, **kwargs):
        state, stats, n = real_epoch(loader, state, *args, **kwargs)
        epochs.append({**stats, "steps": n})
        states.append(state)
        return state, stats, n

    def atomic(path, write):
        writes.append(path)
        return real_atomic(path, write)

    def build(*args, **kwargs):
        step = real_build(*args, **kwargs)

        def recorded(state, *batch):
            state, m = step(state, *batch)
            steps.append({"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item()})
            return state, m

        return recorded

    loop.run_train_epoch, checkpoint._atomic, setup.build_train_step = epoch, atomic, build
    reset_counts()
    torch.cuda.init()  # a fresh rank process: the allocator's stats exist once CUDA is up
    torch.cuda.reset_peak_memory_stats(device)
    try:
        out = loop.train_and_get_best_model(cfg, run_dir=run_dir, device=device)
    finally:
        loop.run_train_epoch, checkpoint._atomic, setup.build_train_step = \
            real_epoch, real_atomic, real_build
    return {
        "rank": distributed.process_index(),
        "world": distributed.process_count(),
        "counts": read_counts(),
        "peak_bytes": torch.cuda.max_memory_allocated(device),
        "steps": steps,
        "epochs": epochs,
        "vals": [s for _, s in out["val_history"]],
        "best_score": out["best_score"],
        "checksums": {name: distributed.checksum(getattr(states[-1], name).state_dict().values())
                      for name in ("hrnet", "shiftnet")},
        "writes": writes,
        "final": {f"{name}.{k}": v.detach().cpu() for name in ("hrnet", "shiftnet")
                  for k, v in getattr(states[-1], name).state_dict().items()},
    }


def interleaved_split(world: int, local_batch: int):
    """train_val_split with the train scenes in the global-batch order of
    ``world`` ranks (rank 0's rows of each batch, then rank 1's, ...), so
    one process sees the ranks' global batches row for row."""
    from highresnet_tpu_torch.data.pipeline import shard_for_hosts
    from highresnet_tpu_torch.train import loop

    real = loop.train_val_split

    def split(dirs, prop, seed=1):
        train, val = real(dirs, prop, seed=seed)
        shards = [shard_for_hosts(train, r, world) for r in range(world)]
        mixed = []
        for k in range(len(shards[0]) // local_batch):
            for shard in shards:
                mixed += shard[k * local_batch:(k + 1) * local_batch]
        return mixed, val

    return split


def one_process_oracle(cfg: dict, run_dir: str, world: int) -> dict:
    """The one-process run at the global batch that ``world`` ranks make."""
    from highresnet_tpu_torch.train import loop

    real = loop.train_val_split
    loop.train_val_split = interleaved_split(world, cfg["training"]["batch_size"] // world)
    try:
        return recorded_train(cfg, run_dir, "cuda")
    finally:
        loop.train_val_split = real


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(commands: list, envs: list, logs: list) -> None:
    """Start every rank together; fail when one exits non-zero or any runs
    past DIST_TIMEOUT_S, killing the rest either way."""
    import subprocess

    procs = []
    try:
        for cmd, env, log in zip(commands, envs, logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(cmd, env=env, cwd=REPO, stdout=f,
                                              stderr=subprocess.STDOUT))
        deadline = time.monotonic() + DIST_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            with open(log) as f:
                raise AssertionError(f"[dist] rank {rank} exited {p.returncode} (a kill is a "
                                     f"timeout of {DIST_TIMEOUT_S} s):\n{f.read()[-6000:]}")


def rank_env(port: int, world: int, rank: int, local_rank: bool) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("HRN_")}
    env.update(HRN_COORDINATOR=f"localhost:{port}", HRN_NUM_PROCESSES=str(world),
               HRN_PROCESS_ID=str(rank),
               # the ranks share the host's cores: spinning thread pools would oversubscribe them
               OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 1) // world)))
    if local_rank:
        env["LOCAL_RANK"] = str(rank)
    return env


def dist_child(rank: int, world: int, cfg_path: str, run_dir: str, out_path: str) -> None:
    """One rank of [dist]'s Gloo run (``chip_smoke.py --dist-rank ...``)."""
    import datetime

    from highresnet_tpu_torch.kernels import build
    from highresnet_tpu_torch.parallel import distributed
    from highresnet_tpu_torch.runtime import setup_device

    device = setup_device("cuda:0")
    distributed.maybe_initialize(device, backend="gloo",
                                 timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    if (distributed.process_index(), distributed.process_count()) != (rank, world):
        raise AssertionError("the process group does not match the rank's arguments")
    build.load()
    with open(cfg_path) as f:
        cfg = json.load(f)
    record = recorded_train(cfg, run_dir, "cuda:0")
    torch.save(record.pop("final"), out_path + ".pt")
    with open(out_path, "w") as f:
        json.dump(record, f)
    distributed.shutdown()


def dist_want(cfg: dict, epochs: list, n_val: int, world: int) -> dict:
    """K1/K2/K3 launches of one process's run: K1 once per fusion round of
    each train and val forward, K2 per round of each backward, K3 per step;
    each rank runs one val forward per val batch (its rows of it)."""
    t = cfg["training"]
    rounds = int(np.log2(t["min_L"]))
    steps = sum(e["steps"] for e in epochs)
    val_forwards = len(epochs) * -(-n_val // t["eval_batch_size"])
    return {"pack": rounds * (steps + val_forwards), "unpack": rounds * steps, "lanczos": steps,
            "pack_dma": 0}


def ms_per_step(record: dict) -> float:
    """The last epoch's wall time per step (loader included)."""
    last = record["epochs"][-1]
    return last["seconds"] / last["steps"] * 1e3


def epoch_readings(record: dict) -> dict:
    """Per-epoch train loss, val score and mean grad_norm of a run."""
    return {"loss": [e["train_loss"] for e in record["epochs"]], "val": record["vals"],
            "grad_norm": [e["grad_norm"] for e in record["epochs"]]}


def rel_diffs(record: dict, oracle: dict) -> dict:
    """Each epoch reading's relative distance from the one-process run's."""
    got, want = epoch_readings(record), epoch_readings(oracle)
    return {k: [abs(a - b) / abs(b) for a, b in zip(got[k], want[k])] for k in want}


def noise_floor(cfg: dict, run_dir: str, replicas: int, oracle: dict) -> dict:
    """How far other convolution algorithms alone move the one-process run:
    the same run with cuDNN off, against ``oracle`` (``rel_diffs``)."""
    torch.backends.cudnn.enabled = False
    try:
        twin = one_process_oracle(cfg, run_dir, replicas)
    finally:
        torch.backends.cudnn.enabled = True
    return rel_diffs(twin, oracle)


def held_epochs(cfg: dict, oracle: dict) -> int:
    """The leading epochs of the one-process run whose predicted shifts all
    stay inside the warp's accurate window. Past the epoch where ShiftNet
    leaves it the registered loss degrades alignments it cannot express, a
    gradient spike follows, and rounding alone moves the run by more than a
    noise floor measured once can bound."""
    from highresnet_tpu_torch.train.epoch import warp_window_px

    window = warp_window_px(cfg["training"])
    held = 0
    for e in oracle["epochs"]:
        if e["max_abs_shift"] > window:
            break
        held += 1
    return held


def check_parity(tag: str, ranks: list, oracle: dict, floor: dict, held: int) -> None:
    """The epochs before the one-process run leaves the warp window
    (``held_epochs``): each step's loss and grad_norm within STEP_LOSS_RTOL
    and STEP_GRAD_NORM_RTOL of the one-process run (the same weights and
    batches); each epoch's loss, val score and mean grad_norm within those
    limits (the val within DIST_VAL_RTOL) or NOISE_FACTOR times ``floor``
    (``noise_floor``, measured in the same call), the larger. Later epochs
    are printed, not held. Prints every step's relative differences before
    it fails."""
    limits = {"loss": STEP_LOSS_RTOL, "val": DIST_VAL_RTOL, "grad_norm": STEP_GRAD_NORM_RTOL}
    held_steps = max(1, sum(e["steps"] for e in oracle["epochs"][:held]))
    for rank, r in enumerate(ranks):
        if len(r["epochs"]) != len(oracle["epochs"]) or len(r["vals"]) != len(oracle["vals"]):
            raise AssertionError(f"[{tag}] rank {rank} ran other epochs than the one process")
        got, want = epoch_readings(r), epoch_readings(oracle)
        pairs = [(f"epoch {i + 1} {name}", a, b, max(limits[name], NOISE_FACTOR * floor[name][i]))
                 for name in limits for i, (a, b) in enumerate(zip(got[name], want[name]))
                 if i < held]
        pairs += [(f"step {i + 1} {k}", a[k], b[k], limits[k])
                  for i, (a, b) in enumerate(zip(r["steps"][:held_steps], oracle["steps"]))
                  for k in ("loss", "grad_norm")]
        worst, over = {}, []
        for name, got_x, want_x, limit in pairs:
            rel = abs(got_x - want_x) / abs(want_x)
            worst[name.split()[-1]] = max(worst.get(name.split()[-1], 0.0), rel)
            if rel > limit:
                over.append(f"{name} {got_x} vs one process {want_x} (rel {rel:.2e} > {limit})")
        per_step = ", ".join(f"{abs(a['loss'] - b['loss']) / abs(b['loss']):.2e}/"
                             f"{abs(a['grad_norm'] - b['grad_norm']) / abs(b['grad_norm']):.2e}"
                             for a, b in zip(r["steps"], oracle["steps"]))
        later = ", ".join(f"epoch {i + 1} {k} {rel_diffs(r, oracle)[k][i]:.2e}"
                          for i in range(held, len(oracle["epochs"])) for k in limits)
        print(f"[{tag}] rank {rank} of {len(ranks)} vs one process at the global batch: "
              f"{len(r['epochs'])} epochs, {held} held (inside the warp window) and "
              f"{held_steps} steps: max rel loss {worst.get('loss', 0.0):.2e}, val "
              f"{worst.get('val', 0.0):.2e}, grad_norm {worst.get('grad_norm', 0.0):.2e} (limits "
              f"{STEP_LOSS_RTOL} / {DIST_VAL_RTOL} / {STEP_GRAD_NORM_RTOL} or {NOISE_FACTOR} x "
              f"the noise floor); each step's rel loss/grad_norm {per_step}"
              + (f"; not held, past the window: {later}" if later else ""))
        if over:
            raise AssertionError(f"[{tag}] rank {rank}: " + "; ".join(over))


def phase_dist(card: str, tmp: str) -> tuple[dict, dict, dict]:
    """Data parallelism through ``train_and_get_best_model``: two ranks on
    one card over Gloo against one process at the same global batch and that
    run's ``noise_floor``, then ``cli.train`` under HRN_COORDINATOR with NCCL
    on every visible card. Returns the K1/K2/K3 launches summed over the
    Gloo ranks, the one-process run at the two ranks' global batches and
    its noise floor."""
    from highresnet_tpu_torch.data import discover_scenes, train_val_split

    world = DIST["world"]
    cfg, cfg_path = dist_config(tmp, "dist_runs")
    t = cfg["training"]
    scenes = discover_scenes(os.path.join(cfg["paths"]["prefix"], "train"))
    n_val = len(train_val_split(scenes, t["val_proportion"], seed=1)[1])

    # the one-process oracle first, alone on the card
    torch.cuda.empty_cache()
    oracle = one_process_oracle(cfg, os.path.join(tmp, "dist_one"), world)
    want_one = dist_want(cfg, oracle["epochs"], n_val, 1)
    if oracle["counts"] != want_one:
        raise AssertionError(f"[dist] one-process launches {oracle['counts']} != {want_one}")
    floor = noise_floor(cfg, os.path.join(tmp, "dist_twin"), world, oracle)
    print(f"[dist] noise floor at batch {t['batch_size']} in {world} shards: the one-process "
          f"run with cuDNN off vs on, per epoch rel " + ", ".join(
              f"{k} {' '.join(f'{x:.2e}' for x in xs)}" for k, xs in floor.items())
          + "; the one-process run's grad_norm by step "
          + " ".join(f"{x['grad_norm']:.3f}" for x in oracle["steps"]))
    torch.cuda.empty_cache()

    port, run_dir = free_port(), os.path.join(tmp, "dist_two")
    outs = [os.path.join(tmp, f"dist_rank{r}.json") for r in range(world)]
    t0 = time.perf_counter()
    run_ranks(
        [[sys.executable, str(REPO / "chip_smoke.py"), "--dist-rank", str(r), str(world),
          cfg_path, run_dir, outs[r]] for r in range(world)],
        [rank_env(port, world, r, local_rank=False) for r in range(world)],
        [os.path.join(tmp, f"dist_rank{r}.log") for r in range(world)],
    )
    wall = time.perf_counter() - t0
    ranks = []
    for out in outs:
        with open(out) as f:
            ranks.append(json.load(f))
    check_parity("dist", ranks, oracle, floor, held_epochs(cfg, oracle))
    final = torch.load(outs[0] + ".pt", weights_only=True)
    diffs = sorted(((float((final[k].double() - v.double()).abs().max()), k)
                    for k, v in oracle["final"].items() if v.is_floating_point()), reverse=True)
    print(f"[dist] final weights, rank 0 against one process: largest max|diff| "
          f"{', '.join(f'{k} {d:.3e}' for d, k in diffs[:4])}")
    if any(r["checksums"] != ranks[0]["checksums"] for r in ranks):
        raise AssertionError(f"[dist] the ranks end with different weights: "
                             f"{[r['checksums'] for r in ranks]}")
    if not ranks[0]["writes"] or any(r["writes"] for r in ranks[1:]):
        raise AssertionError("[dist] a rank other than 0 wrote, or rank 0 wrote nothing")
    if any(not w.startswith(run_dir) for w in ranks[0]["writes"]):
        raise AssertionError("[dist] rank 0 wrote outside the run directory")
    summed = {k: sum(r["counts"][k] for r in ranks) for k in ranks[0]["counts"]}
    want = {k: world * v for k, v in dist_want(cfg, ranks[0]["epochs"], n_val, world).items()}
    print(f"[dist] {world} ranks on cuda:0 over Gloo, {len(ranks[0]['epochs'])} epochs x "
          f"{ranks[0]['epochs'][0]['steps']} steps at {t['batch_size'] // world} scenes a rank, "
          f"eval batch {t['eval_batch_size']} sharded: final weights bit-identical "
          f"({ranks[0]['checksums']}), best score {ranks[0]['best_score']} on both "
          f"(one process {oracle['best_score']}), rank 0 alone wrote "
          f"{len(ranks[0]['writes'])} files; launches summed over the ranks {summed} "
          f"(expected {want}); one process {oracle['counts']}")
    if summed != want:
        raise AssertionError(f"[dist] launches {summed} != {want}")
    if any(r["best_score"] != ranks[0]["best_score"] for r in ranks):
        raise AssertionError("[dist] the ranks selected different best scores")
    print(f"[dist] ms per step (last epoch's wall time per step, loader included): one process "
          f"batch {t['batch_size']} {ms_per_step(oracle):.3f}, {world} Gloo ranks sharing the "
          f"card at {t['batch_size'] // world} each {ms_per_step(ranks[0]):.3f} (gradients and "
          f"statistics staged through host memory; not a scaling figure); rank processes "
          f"{wall:.1f} s wall, start-up included; {card}")
    phase_dist_nccl(card, tmp, n_val)
    return summed, oracle, floor


def phase_dist_nccl(card: str, tmp: str, n_val: int, view: int = 1) -> None:
    """``cli.train`` under HRN_COORDINATOR with NCCL, one rank per visible
    card (LOCAL_RANK picks it), against one process at the same global batch;
    with ``view`` > 1 on the 2-D layout {"data": cards // view, "view": view}
    over data·view cards."""
    world = view * (torch.cuda.device_count() // view)
    tag = "dist-nccl" if view == 1 else "view-nccl"
    cfg, _ = dist_config(tmp, f"{tag}_runs")
    torch.cuda.empty_cache()
    oracle = one_process_oracle(cfg, os.path.join(tmp, f"{tag}_one"), world // view)
    floor = None
    if view > 1:
        floor = noise_floor(cfg, os.path.join(tmp, f"{tag}_twin"), world // view, oracle)
        cfg["training"]["mesh"] = {"data": world // view, "view": view}
    torch.cuda.empty_cache()
    cfg_path = os.path.join(tmp, f"{tag}.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    port, run_dir = free_port(), os.path.join(tmp, f"{tag}_run")
    logs = [os.path.join(tmp, f"{tag}_rank{r}.log") for r in range(world)]
    t0 = time.perf_counter()
    run_ranks(
        [[sys.executable, "-m", "highresnet_tpu_torch.cli.train", "--config", cfg_path,
          "--run-dir", run_dir, "--device", "cuda"] for _ in range(world)],
        [rank_env(port, world, r, local_rank=True) for r in range(world)],
        logs,
    )
    wall = time.perf_counter() - t0
    with open(logs[0]) as f:
        lines = [ln.split() for ln in f if ln.startswith("epoch ")]
    printed = [dict(p.split("=") for p in ln[2:] if "=" in p) for ln in lines]
    if len(printed) != len(oracle["epochs"]):
        raise AssertionError(f"[{tag}] rank 0 printed {len(printed)} epochs, expected "
                             f"{len(oracle['epochs'])}")
    worst, held = 0.0, held_epochs(cfg, oracle)
    for i, (p, e, v) in enumerate(zip(printed, oracle["epochs"], oracle["vals"])):
        if i >= held:  # as check_parity holds the Gloo ranks
            continue
        loss_limit, val_limit = STEP_LOSS_RTOL, DIST_VAL_RTOL
        if floor:
            loss_limit = max(loss_limit, NOISE_FACTOR * floor["loss"][i])
            val_limit = max(val_limit, NOISE_FACTOR * floor["val"][i])
        for got, want, limit in ((float(p["loss"]), e["train_loss"], loss_limit),
                                 (float(p["val"]), v, val_limit)):
            # the log prints 4 decimals: half a unit of the last one is allowed on top
            if abs(got - want) > limit * abs(want) + 5e-5:
                raise AssertionError(f"[{tag}] printed {got} vs one process {want}")
            worst = max(worst, abs(got - want) / abs(want))
    for log in logs[1:]:
        with open(log) as f:
            if any(ln.startswith("epoch ") for ln in f):
                raise AssertionError(f"[{tag}] a rank other than 0 printed epochs")
    print(f"[{tag}] cli.train on {world} card(s), NCCL under HRN_COORDINATOR (world {world}, "
          f"training.mesh {cfg['training'].get('mesh')}: the init, the step's collectives, the "
          f"eval all-gather and the checks ran): "
          f"{len(printed)} epochs ({held} inside the warp window held), printed loss/val vs "
          f"one process at batch {cfg['training']['batch_size']}: max rel {worst:.2e} (limits "
          f"{STEP_LOSS_RTOL} / {DIST_VAL_RTOL} + print rounding"
          + (f", or {NOISE_FACTOR} x the noise floor {floor}" if floor else "")
          + f"); {wall:.1f} s wall for the rank processes, start-up included; {card}")


# [view]: [dist]'s config and set on the 2-D layout (training.mesh), each
# rank a Gloo process on the one card, against the one-process run at the
# same global batch (the replicas' shards interleaved by data index): at
# data 2 that is [dist]'s own one-process run
VIEW_LAYOUTS = ({"data": 1, "view": 2}, {"data": 2, "view": 2})


def view_gather_bytes(cfg: dict, data: int, view: int) -> int:
    """Bytes of the fusion states one rank gathers over its view group in a
    train step's forward (its backward all-reduces as many): every round
    that starts sharded gathers the whole (B / data, views, C, H, W) state."""
    t, c = cfg["training"], cfg["network"]["encoder"]["channel_size"]
    per_view = t["batch_size"] // data * c * t["patch_size"] ** 2 * 4  # f32
    total, nviews, sharded = 0, t["min_L"], view > 1
    while nviews // 2 > 0 and sharded:
        total += nviews * per_view
        sharded = (nviews // 2) % view == 0
        nviews //= 2
    return total


def phase_view(card: str, tmp: str, oracle_data2: dict, floor_data2: dict) -> dict:
    """The 2-D layout through ``train_and_get_best_model``: each of
    VIEW_LAYOUTS on data·view Gloo ranks sharing the card against one process
    at the same global batch and that run's ``noise_floor`` (at data 2
    [dist]'s: ``oracle_data2``, ``floor_data2``), then ``cli.train`` with NCCL on the layout over every
    pair of visible cards. Returns the K1/K2/K3 launches summed over the
    Gloo ranks."""
    from highresnet_tpu_torch.data import discover_scenes, train_val_split

    t0 = time.perf_counter()
    cfg, _ = dist_config(tmp, "view_runs")
    t = cfg["training"]
    scenes = discover_scenes(os.path.join(cfg["paths"]["prefix"], "train"))
    n_val = len(train_val_split(scenes, t["val_proportion"], seed=1)[1])
    torch.cuda.empty_cache()
    oracles = {1: one_process_oracle(cfg, os.path.join(tmp, "view_one"), 1), 2: oracle_data2}
    floors = {1: noise_floor(cfg, os.path.join(tmp, "view_twin1"), 1, oracles[1]),
              2: floor_data2}
    for d, floor in floors.items():
        print(f"[view] noise floor at batch {t['batch_size']} in {d} shard(s): the one-process "
              f"run with cuDNN off vs on, per epoch rel " + ", ".join(
                  f"{k} {' '.join(f'{x:.2e}' for x in xs)}" for k, xs in floor.items())
              + "; the one-process run's grad_norm by step "
              + " ".join(f"{x['grad_norm']:.3f}" for x in oracles[d]["steps"]))
    torch.cuda.empty_cache()
    summed = {}
    for layout in VIEW_LAYOUTS:
        data, view = layout["data"], layout["view"]
        world, tag = data * view, f"view {data}x{view}"
        cfg_path, run_dir = os.path.join(tmp, f"view{world}.json"), os.path.join(tmp, f"view{world}")
        with open(cfg_path, "w") as f:
            json.dump({**cfg, "training": {**t, "mesh": layout}}, f)
        outs = [os.path.join(tmp, f"view{world}_rank{r}.json") for r in range(world)]
        port, t1 = free_port(), time.perf_counter()
        run_ranks(
            [[sys.executable, str(REPO / "chip_smoke.py"), "--dist-rank", str(r), str(world),
              cfg_path, run_dir, outs[r]] for r in range(world)],
            [rank_env(port, world, r, local_rank=False) for r in range(world)],
            [os.path.join(tmp, f"view{world}_rank{r}.log") for r in range(world)],
        )
        wall = time.perf_counter() - t1
        ranks = []
        for out in outs:
            with open(out) as f:
                ranks.append(json.load(f))
        check_parity(tag, ranks, oracles[data], floors[data], held_epochs(cfg, oracles[data]))
        if any(r["checksums"] != ranks[0]["checksums"] or r["best_score"] != ranks[0]["best_score"]
               for r in ranks):
            raise AssertionError(f"[{tag}] the ranks end with different weights or best scores")
        if not ranks[0]["writes"] or any(r["writes"] for r in ranks[1:]):
            raise AssertionError(f"[{tag}] a rank other than 0 wrote, or rank 0 wrote nothing")
        want = dist_want(cfg, ranks[0]["epochs"], n_val, world)  # every rank packs each round
        for rank, r in enumerate(ranks):
            if r["counts"] != want:
                raise AssertionError(f"[{tag}] rank {rank} launches {r['counts']} != {want}")
        for k in want:
            summed[k] = summed.get(k, 0) + world * want[k]
        gathered = view_gather_bytes(cfg, data, view)
        peaks = ", ".join(f"{r['peak_bytes'] / 2**30:.3f}" for r in ranks)
        print(f"[{tag}] {world} Gloo ranks on cuda:0, {len(ranks[0]['epochs'])} epochs x "
              f"{ranks[0]['epochs'][0]['steps']} steps at {t['batch_size'] // data} scenes a "
              f"replica, {t['min_L'] // view} of {t['min_L']} views encoded a rank: final weights "
              f"bit-identical ({ranks[0]['checksums']}), rank 0 alone wrote "
              f"{len(ranks[0]['writes'])} files; launches on each rank {want}; ms per step "
              f"{ms_per_step(ranks[0]):.3f} (one process {ms_per_step(oracles[data]):.3f}; ranks "
              f"time-share the card, states and gradients staged through host memory: not a "
              f"scaling figure); fusion states gathered over the view group per step "
              f"{gathered / 1e6:.3f} MB forward + {gathered / 1e6:.3f} MB all-reduced backward; "
              f"peak memory per rank {peaks} GiB (one process "
              f"{oracles[data]['peak_bytes'] / 2**30:.3f}); rank processes {wall:.1f} s wall, "
              f"start-up included; {card}")
    if torch.cuda.device_count() >= 2:
        phase_dist_nccl(card, tmp, n_val, view=2)
    else:
        print(f"[view-nccl] cli.train on the 2-D layout over NCCL needs two cards (one rank "
              f"per card); this machine has {torch.cuda.device_count()}: the leg did not run")
    print(f"[view] phase wall {time.perf_counter() - t0:.1f} s; {card}")
    return summed


# [options]: the loop's four options that the CPU tests hold against JAX
# (tests/test_torch_loop_options.py), each through cli.train at the tiny
# width of those tests (8 channels, 4 views of 24 px, patch 16, register 32,
# batch 2, EMA on), every step registered through the fused warp, on a
# misaligned synthetic set without norm.csv (the val score is then -cPSNR in
# dB), ShiftNet's dropout off and no warm-start (the card and the CPU draw
# other masks and crops); the card's run against the port's CPU run of the
# same config. lr 1e-4, not the config's 7e-4: at 7e-4 the f32 run of this
# config parts from its float64 run within 8 steps by nearly
# STEP_GRAD_NORM_RTOL in a step's grad_norm on the CPU alone (Adam's steps
# of ±lr on gradients that are zero in exact arithmetic, hazard H13)
OPTIONS = dict(scenes_per_channel=6, views=5, size=24, hr_shift_sigma=1.25, epochs=2,
               stop_epochs=4, relaunch_epochs=6, patience=1, val_views=[2, 1])
OPTIONS_CONFIG = {
    "network": {
        "encoder": {"in_channels": 2, "num_layers": 1, "kernel_size": 3, "channel_size": 8},
        "recursive": {"alpha_residual": True, "in_channels": 8, "kernel_size": 3},
        "decoder": {
            "deconv": {"in_channels": 8, "kernel_size": 3, "stride": 3, "out_channels": 8},
            "final": {"in_channels": 8, "kernel_size": 1, "out_channels": 1},
        },
    },
    "training": {
        "batch_size": 2, "min_L": 4, "n_views": 4, "crop": 1, "lr": 1e-4, "lr_step": 0,
        "lr_decay": 0.5, "beta": 50.0, "create_patches": True, "patch_size": 16,
        "register_size": 32, "val_proportion": 0.34, "lambda": 1e-6, "n_workers": 1,
        "seed": 0, "eval_batch_size": 2, "checkpoint_every": 1, "register": True,
        "ema_decay": 0.9, "use_pallas_warp": True, "data_parallel": False,
    },
}
OPTIONS_PHASE_LIMIT_S = 40.0


@contextlib.contextmanager
def recording_loop():
    """Each train step's loss and grad_norm, each epoch's stats and the
    number of eval-step calls of the ``train_and_get_best_model`` runs
    inside the block, ShiftNet's dropout off in them."""
    from highresnet_tpu_torch.train import loop, setup

    record = {"steps": [], "epochs": [], "evals": 0}
    real = (loop.run_train_epoch, setup.build_train_step, setup.build_eval_step,
            setup.create_train_state)

    def create_state(*args, **kwargs):  # dropout off: the card and the CPU draw other masks
        state = real[3](*args, **kwargs)
        state.shiftnet.dropout = 0.0
        return state

    def epoch(*args, **kwargs):
        state, stats, n = real[0](*args, **kwargs)
        record["epochs"].append({**stats, "steps": n})
        return state, stats, n

    def build_train(*args, **kwargs):
        step = real[1](*args, **kwargs)

        def recorded(state, *batch):
            state, m = step(state, *batch)
            record["steps"].append({"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item()})
            return state, m

        return recorded

    def build_eval(*args, **kwargs):
        step = real[2](*args, **kwargs)

        def counted(*batch):
            record["evals"] += 1
            return step(*batch)

        return counted

    loop.run_train_epoch, setup.build_train_step, setup.build_eval_step, \
        setup.create_train_state = epoch, build_train, build_eval, create_state
    try:
        yield record
    finally:
        loop.run_train_epoch, setup.build_train_step, setup.build_eval_step, \
            setup.create_train_state = real


def options_run(tmp: str, root: str, name: str, device: str, **training) -> dict:
    """cli.train on ``device`` with OPTIONS_CONFIG and ``training``, in the run
    directory ``name`` (a second call resumes it); the steps and epochs,
    the result and the kernels launched."""
    from highresnet_tpu_torch.cli import train

    cfg = json.loads(json.dumps(OPTIONS_CONFIG))
    cfg["training"].update({"num_epochs": OPTIONS["epochs"], **training})
    cfg["paths"] = {"prefix": root, "checkpoint_dir": os.path.join(tmp, "runs"),
                    "tb_log_file_dir": ""}
    path = os.path.join(tmp, f"{name}_{device}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    with recording_loop() as record:
        reset_counts()
        out = train.main(["--config", path, "--run-dir", os.path.join(tmp, f"{name}_{device}"),
                          "--device", device])
        record["counts"] = read_counts()
    record.update(best_epoch=out["best_epoch"], best_score=out["best_score"],
                  val_history=out["val_history"])
    return record


def options_want(record: dict, views: int) -> dict:
    """A card run's K1/K2/K3 launches: K1 once per fusion round of each train
    and val forward, K2 per round of each backward, K3 once per step (every
    step registered, fused warp)."""
    rounds = int(np.log2(views))
    steps = len(record["steps"])
    return {"pack": rounds * (steps + record["evals"]), "unpack": rounds * steps,
            "lanczos": steps, "pack_dma": 0}


def options_parity(tag: str, gpu: dict, cpu: dict) -> None:
    """The card's run against the CPU run: the same steps and epochs, each
    step's loss within STEP_LOSS_RTOL and grad_norm within
    STEP_GRAD_NORM_RTOL, each epoch's selection score within SCORE_ATOL_DB,
    the val history's epochs and the best epoch equal."""
    if len(gpu["steps"]) != len(cpu["steps"]) or \
            [e for e, _ in gpu["val_history"]] != [e for e, _ in cpu["val_history"]]:
        raise AssertionError(f"[options] {tag}: the card ran other steps or epochs than the CPU: "
                             f"{len(gpu['steps'])} vs {len(cpu['steps'])} steps, "
                             f"{gpu['val_history']} vs {cpu['val_history']}")
    d_loss = max(abs(g["loss"] - c["loss"]) / abs(c["loss"])
                 for g, c in zip(gpu["steps"], cpu["steps"]))
    d_norm = max(abs(g["grad_norm"] - c["grad_norm"]) / c["grad_norm"]
                 for g, c in zip(gpu["steps"], cpu["steps"]))
    d_score = max(abs(g - c) for (_, g), (_, c) in zip(gpu["val_history"], cpu["val_history"]))
    print(f"[options] {tag}: {len(gpu['steps'])} steps, epochs "
          f"{[e for e, _ in gpu['val_history']]}, best epoch {gpu['best_epoch']} (CPU "
          f"{cpu['best_epoch']}); GPU vs CPU max rel loss {d_loss:.2e} (limit {STEP_LOSS_RTOL}), "
          f"grad_norm {d_norm:.2e} (limit {STEP_GRAD_NORM_RTOL}), score {d_score:.2e} dB "
          f"(limit {SCORE_ATOL_DB}); launches {gpu['counts']}")
    if d_loss > STEP_LOSS_RTOL or d_norm > STEP_GRAD_NORM_RTOL or d_score > SCORE_ATOL_DB \
            or gpu["best_epoch"] != cpu["best_epoch"]:
        raise AssertionError(f"[options] {tag}: the card's run and the CPU's disagree")


def phase_options(card: str, tmp: str) -> dict:
    """Each option through cli.train on the card and on the CPU; returns the
    card runs' kernel launches."""
    from highresnet_tpu_torch.data import make_synthetic_dataset

    t0 = time.perf_counter()
    root = make_synthetic_dataset(
        os.path.join(tmp, "options_data"), n_scenes_per_channel=OPTIONS["scenes_per_channel"],
        n_views=OPTIONS["views"], lr_size=OPTIONS["size"], seed=0, splits=("train",),
        hr_shift_sigma=OPTIONS["hr_shift_sigma"], write_norm_csv=False)
    views = OPTIONS_CONFIG["training"]["min_L"]
    summed = dict.fromkeys(("pack", "unpack", "lanczos", "pack_dma"), 0)

    def both(tag: str, name: str, **training) -> dict:
        runs = {d: options_run(tmp, root, name, d, **training) for d in ("cuda", "cpu")}
        want = options_want(runs["cuda"], views)
        if runs["cuda"]["counts"] != want:
            raise AssertionError(f"[options] {tag}: kernel launches {runs['cuda']['counts']} "
                                 f"!= {want}")
        for k in summed:
            summed[k] += runs["cuda"]["counts"][k]
        options_parity(tag, runs["cuda"], runs["cpu"])
        return runs

    uncached = both("cache_val_batches false", "uncached_val", cache_val_batches=False)
    cpu = uncached["cpu"]
    clip = statistics.median(s["grad_norm"] for s in cpu["steps"][:cpu["epochs"][0]["steps"]])
    clipped = both(f"grad_clip_norm {clip:.6g} (the CPU's median first-epoch grad_norm)",
                   "grad_clip", grad_clip_norm=clip)
    for device, run in clipped.items():
        norms = [s["grad_norm"] for s in run["steps"]]
        if not (any(n >= clip for n in norms) and any(n < clip for n in norms)):
            raise AssertionError(f"[options] grad_clip_norm {clip} binds on all steps or none "
                                 f"on {device}: {norms}")
    both(f"val_views {OPTIONS['val_views']}", "val_views", val_views=OPTIONS["val_views"])
    # lr 0: the val score never improves after epoch 1, so the run stops at
    # 1 + patience; relaunched with more epochs it runs one epoch and stops
    stop = dict(lr=0.0, early_stop_patience=OPTIONS["patience"])
    for tag, epochs, last, ran in (("early_stop_patience", OPTIONS["stop_epochs"], 2, 2),
                                   ("early_stop relaunch", OPTIONS["relaunch_epochs"], 3, 1)):
        runs = both(f"{tag} {OPTIONS['patience']} at lr 0, num_epochs {epochs}", "early_stop",
                    num_epochs=epochs, **stop)
        for device, run in runs.items():
            got = (run["val_history"][-1][0], len(run["epochs"]), run["best_epoch"])
            if got != (last, ran, 1):
                raise AssertionError(f"[options] {tag} on {device}: (last epoch, epochs run, "
                                     f"best epoch) {got} != {(last, ran, 1)}")
    wall = time.perf_counter() - t0
    print(f"[options] launches {summed}; phase wall {wall:.1f} s (limit "
          f"{OPTIONS_PHASE_LIMIT_S} s); {card}")
    if wall > OPTIONS_PHASE_LIMIT_S:
        raise AssertionError(f"[options] the phase took {wall:.1f} s")
    return summed


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


STAGES = tuple(FLAGSHIP["epochs"])
# kernel launches per served scene: K1 once per fusion round of each forward
# (x8 TTA's eight members are one stacked forward), K3 once per scene on the
# aligned and registered paths (one batched warp)
SERVE_MODES = {
    "plain": ([], {"pack": 1, "lanczos": 0}),
    "tta8": (["--tta", "8"], {"pack": 1, "lanczos": 1}),
    "registered": (["--registered"], {"pack": 1, "lanczos": 1}),
    "ensemble": ([], {"pack": 2, "lanczos": 1}),
    "bicubic": (["--top-k", "1"], {"pack": 0, "lanczos": 0}),
}


def flagship_configs(tmp: str) -> tuple[dict, dict]:
    """configs/flagship*.json on a synthetic misaligned 16-view 128 px set,
    each stage's init_params_from pointed at the stage before; returns the
    config paths and run dirs by stage."""
    from highresnet_tpu_torch import load_config
    from highresnet_tpu_torch.data import make_synthetic_dataset

    root = make_synthetic_dataset(
        os.path.join(tmp, "data"), n_scenes_per_channel=FLAGSHIP["scenes_per_channel"],
        n_views=FLAGSHIP["views"], lr_size=FLAGSHIP["size"], seed=0, splits=("train",),
        hr_shift_sigma=FLAGSHIP["hr_shift_sigma"],
    )
    paths, runs = {}, {}
    for i, name in enumerate(STAGES):
        cfg = load_config(str(REPO / "configs" / f"{name}.json"))
        t = cfg["training"]
        cfg["paths"].update(prefix=root, checkpoint_dir=os.path.join(tmp, "runs"), tb_log_file_dir="")
        t["num_epochs"] = FLAGSHIP["epochs"][name]
        if t.get("register_warmup_epochs"):
            t["register_warmup_epochs"] = FLAGSHIP["register_warmup_epochs"]
        if i:
            t["init_params_from"] = runs[STAGES[i - 1]]
        runs[name] = os.path.join(tmp, "runs", name)
        paths[name] = os.path.join(tmp, f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(cfg, f)
    print(f"[flagship] configs/{{{','.join(STAGES)}}}.json as shipped (batch 32, 16 views, 32 px "
          f"patches, register 64, warp_int_range 4, D4 augmentation, range_penalty and "
          f"variable_views_p as configured, warm-start 400 steps), cut: data = "
          f"{2 * FLAGSHIP['scenes_per_channel']} synthetic misaligned train scenes (hr_shift_sigma "
          f"{FLAGSHIP['hr_shift_sigma']}, {FLAGSHIP['views']} views of {FLAGSHIP['size']} px, HR "
          f"{3 * FLAGSHIP['size']} px); num_epochs {'/'.join(map(str, FLAGSHIP['epochs'].values()))}"
          f" (from 300/100/100); register_warmup_epochs {FLAGSHIP['register_warmup_epochs']} "
          f"(from 30), so both the unregistered and the registered step run")
    return paths, runs


def flagship_warmstart(cfg_path: str, card: str) -> dict:
    """The stage-1 warm-start (``maybe_warmstart_shiftnet``) twice from the
    same seed: bit-identical ShiftNets, no kernel launched (warp_int_range 4
    takes the plain extended warp), final RMSE and ms per step. Then its
    fused-warp branch (warp_int_range 0, use_pallas_warp) for a few steps,
    K3 once per step, whose launches it returns; and the pairs that branch
    warps against the plain warp's."""
    from highresnet_tpu_torch import load_config
    from highresnet_tpu_torch.data import discover_scenes, train_val_split
    from highresnet_tpu_torch.train.pretrain import hr_crop_pool, warm_start_pairs
    from highresnet_tpu_torch.train.setup import maybe_warmstart_shiftnet
    from highresnet_tpu_torch.train.state import create_train_state

    cfg = load_config(cfg_path)
    t = cfg["training"]
    scenes = discover_scenes(os.path.join(cfg["paths"]["prefix"], "train"))
    train_list, _ = train_val_split(scenes, t["val_proportion"], seed=1)
    steps, seed = t["shiftnet_warmup_steps"], t["seed"]
    runs = []
    reset_counts()
    for _ in range(2):
        state = create_train_state(cfg, "cuda", torch.Generator().manual_seed(seed))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rmse = maybe_warmstart_shiftnet(state, t, train_list, seed)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        runs.append((rmse, ms, {k: v.detach().clone() for k, v in state.shiftnet.state_dict().items()}))
    counts = read_counts()
    same = all(torch.equal(v, runs[1][2][k]) for k, v in runs[0][2].items())
    print(f"[flagship] warm-start: {steps} steps, {t['register_size']} px crops, batch 32, sigma "
          f"{t['shiftnet_warmup_sigma']}: final shift RMSE {runs[0][0]:.4f} and {runs[1][0]:.4f} px "
          f"(zero-init predicts 0: RMSE about sigma), {runs[0][1]:.3f} and {runs[1][1]:.3f} ms/step "
          f"(host clock, the HR crops' read included, sync at the end); the second run from the "
          f"same seed bit-identical: {same}; launches {counts}; {card}")
    if not same:
        raise AssertionError("two warm-starts from one seed ended apart")
    if not runs[0][0] < t["shiftnet_warmup_sigma"]:
        raise AssertionError(f"the warm-start did not learn: RMSE {runs[0][0]}")
    if any(counts.values()):
        raise AssertionError(f"the warm-start at warp_int_range 4 launched kernels: {counts}")

    fused = {**t, "warp_int_range": 0, "use_pallas_warp": True,
             "shiftnet_warmup_steps": FUSED_WARMUP_STEPS}
    state = create_train_state(cfg, "cuda", torch.Generator().manual_seed(seed))
    reset_counts()
    rmse = maybe_warmstart_shiftnet(state, fused, train_list, seed)
    counts = read_counts()
    want = {"pack": 0, "unpack": 0, "lanczos": FUSED_WARMUP_STEPS, "pack_dma": 0}
    pool = torch.from_numpy(hr_crop_pool(train_list, t["register_size"])).cuda()
    g = torch.Generator().manual_seed(6)
    idx = torch.randint(len(pool), (t["batch_size"],), generator=g).cuda()
    d = (torch.rand((t["batch_size"], 2), generator=g) * 6 - 3).cuda()
    err = (warm_start_pairs(pool, idx, d, 0, True) - warm_start_pairs(pool, idx, d, 0, False)).abs()
    err = err.max().item()
    print(f"[flagship] warm-start's fused branch (warp_int_range 0, use_pallas_warp): "
          f"{FUSED_WARMUP_STEPS} steps, final shift RMSE {rmse:.4f} px, launches {counts} "
          f"(expected {want}); its pairs ({t['batch_size']}, 2, {t['register_size']}, "
          f"{t['register_size']}) against the plain warp's, shifts in ±3 px: max|diff| {err:.3e} "
          f"(limit {WARP_ATOL})")
    if counts != want:
        raise AssertionError(f"the fused warm-start launched {counts}, not {want}")
    if not (np.isfinite(rmse) and err <= WARP_ATOL):
        raise AssertionError("the fused warm-start's warp disagrees with the plain warp")
    return counts


def flagship_train(paths: dict, runs: dict) -> dict:
    """The three stages through cli.train, chained by init_params_from; K1 on
    every forward, K2 on every backward, K3 none (warp_int_range 4)."""
    from highresnet_tpu_torch import load_config
    from highresnet_tpu_torch.cli import train
    from highresnet_tpu_torch.data import discover_scenes, train_val_split
    from highresnet_tpu_torch.models.convert import SHIFTNET_NAME

    rounds = int(np.log2(FLAGSHIP["views"]))
    totals = dict.fromkeys(("pack", "unpack", "lanczos", "pack_dma"), 0)
    for name in STAGES:
        cfg = load_config(paths[name])
        t = cfg["training"]
        reset_counts()
        out = train.main(["--config", paths[name], "--run-dir", runs[name], "--device", "cuda"])
        counts = read_counts()
        scenes = discover_scenes(os.path.join(cfg["paths"]["prefix"], "train"))
        train_list, val = train_val_split(scenes, t["val_proportion"], seed=1)
        epochs = t["num_epochs"]
        steps = epochs * -(-len(train_list) // t["batch_size"])
        val_forwards = epochs * -(-len(val) // t["eval_batch_size"])
        want = {"pack": rounds * (steps + val_forwards), "unpack": rounds * steps, "lanczos": 0,
                "pack_dma": 0}
        print(f"[flagship] cli.train {name}: {steps} steps, {val_forwards} val forwards, init from "
              f"{t.get('init_params_from') or 'the seed'}; launches {counts} (expected {want}); "
              f"last epoch loss {out['train_loss']}, best score {out['best_score']} (epoch "
              f"{out['best_epoch']})")
        if counts != want:
            raise AssertionError(f"kernel launches in {name} {counts} != {want}")
        if not (np.isfinite(out["train_loss"]) and np.isfinite(out["best_score"])):
            raise AssertionError(f"non-finite train loss or val score in {name}")
        if not os.path.isfile(os.path.join(runs[name], "best", SHIFTNET_NAME)):
            raise AssertionError(f"{name} wrote no best/ShiftNet.pth")
        for k in totals:
            totals[k] += counts[k]
    return totals


def flagship_step_time(cfg_path: str, card: str) -> None:
    """Stage 1's registered train step (batch 32, 16 views, 32 px patches,
    register 64, the plain extended warp) on one loader batch: on the GPU
    (K1 and K2 at the flagship's shapes) against the port's CPU path, then
    timed."""
    from highresnet_tpu_torch import load_config
    from highresnet_tpu_torch.data import discover_scenes, train_val_split
    from highresnet_tpu_torch.train.epoch import batch_to_device
    from highresnet_tpu_torch.train.setup import build_train_loader
    from highresnet_tpu_torch.train.state import create_train_state
    from highresnet_tpu_torch.train.step import build_train_step

    cfg = load_config(cfg_path)
    t = cfg["training"]
    scenes = discover_scenes(os.path.join(cfg["paths"]["prefix"], "train"))
    train_list, _ = train_val_split(scenes, t["val_proportion"], seed=1)
    batch = next(iter(build_train_loader(t, train_list, seed=t["seed"],
                                         data_dir=cfg["paths"]["prefix"])))
    step_gpu_vs_cpu(cfg, batch, "flagship")
    state = create_train_state(cfg, "cuda", torch.Generator().manual_seed(t["seed"]))
    step = build_train_step(cfg)
    args = batch_to_device(batch, torch.device("cuda"))
    for _ in range(2):  # warm-up
        step(state, *args)
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, *args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    b, l, p = batch.lrs.shape[0], batch.lrs.shape[1], t["patch_size"]
    print(f"[flagship] registered train step, batch {b} x {l} views x {p} px (SR {3 * p} px, "
          f"register {t['register_size']}, warp_int_range {t['warp_int_range']}): {ms:.3f} ms/step, "
          f"{b / ms * 1e3:.1f} scenes/s (median of 10, host clock with sync); {card}")


def flagship_model(cfg: dict, runs: dict, mode: str, device: str):
    """The Model cli.predict builds for ``mode``, served from the last stage."""
    from highresnet_tpu_torch.eval.evaluator import Model

    model = Model(cfg, device=device)
    last = runs[STAGES[-1]]
    if mode == "ensemble":
        model.load_ensemble([runs[STAGES[-2]], last])
    elif mode == "registered":
        model.load_checkpoint_with_shiftnet(last)
    else:
        model.load_checkpoint(last)
        if mode == "tta8":
            model.enable_tta(transforms=8)
    return model


def tta_member_shifts(model, batch) -> np.ndarray:
    """The PCC shifts (7, 2) that x8 TTA aligns its members by, on the model's
    device: the members' SRs as its forward computes them, one stacked forward."""
    from highresnet_tpu_torch.models.layers import stacked_members
    from highresnet_tpu_torch.ops.dihedral import dihedral_fwd, dihedral_inv
    from highresnet_tpu_torch.registration.search import pcc_align_batch

    x = torch.from_numpy(batch.lrs).to(model.device)
    a = torch.from_numpy(batch.alphas).to(model.device)
    with torch.inference_mode(), stacked_members(8):
        out = model.hrnet(torch.cat([dihedral_fwd(x, t) for t in range(8)]), a.repeat(8, 1))
        srs = [dihedral_inv(sr, t) for t, sr in enumerate(out.split(x.shape[0]))]
        return pcc_align_batch(srs[0].repeat(7, 1, 1), torch.cat(srs[1:]))[1].cpu().numpy()


def flagship_serve(paths: dict, runs: dict, card: str) -> dict:
    """cli.predict on the last stage: plain, --tta 8, --registered, the
    two-member ensemble and the bicubic route (--top-k 1), each with its
    launches per scene; then ms per scene, and one val scene under --tta 8
    and --registered on the GPU against the port's CPU path."""
    from highresnet_tpu_torch import load_config
    from highresnet_tpu_torch.cli import predict
    from highresnet_tpu_torch.data import collate
    from highresnet_tpu_torch.eval.evaluator import load_data

    cfg_path = paths[STAGES[-1]]
    cfg = load_config(cfg_path)
    rounds = int(np.log2(FLAGSHIP["views"]))
    totals = dict.fromkeys(("pack", "unpack", "lanczos", "pack_dma"), 0)
    for mode, (flags, per_scene) in SERVE_MODES.items():
        checkpoints = [runs[STAGES[-2]], runs[STAGES[-1]]] if mode == "ensemble" else [runs[STAGES[-1]]]
        reset_counts()
        table = predict.main(["--config", cfg_path, "--splits", "val", "--device", "cuda",
                              "--checkpoint", *checkpoints, *flags])
        counts = read_counts()
        scores = table["model"].astype(float).to_dict()
        n = len(scores)
        want = {"pack": rounds * per_scene["pack"] * n, "unpack": 0,
                "lanczos": per_scene["lanczos"] * n, "pack_dma": 0}
        print(f"[flagship] cli.predict {mode} ({' '.join(flags) or 'no flags'}, "
              f"{len(checkpoints)} checkpoint(s)): {n} val scenes, launches {counts} (expected "
              f"{want}), scores {scores}")
        if counts != want:
            raise AssertionError(f"kernel launches in predict {mode} {counts} != {want}")
        if not n or not all(np.isfinite(v) for v in scores.values()):
            raise AssertionError(f"predict {mode} gave {scores}")
        for k in totals:
            totals[k] += counts[k]

    val = load_data(cfg_path)[1]
    batches = [collate([s], cfg["training"]["min_L"]) for s in val]
    for mode in ("plain", "tta8", "registered", "ensemble"):
        model = flagship_model(cfg, runs, mode, "cuda")
        registered = mode == "registered"
        model(batches[0], registered)  # warm-up
        times = []
        for _ in range(SERVE_REPS):
            for b in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model(b, registered)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        print(f"[flagship] serve {mode}: {statistics.median(times):.3f} ms per scene (SR and "
              f"shift-cPSNR, {FLAGSHIP['views']} views of {FLAGSHIP['size']} px, batch 1, f32; median of "
              f"{len(times)}: "
              f"{len(batches)} val scenes x {SERVE_REPS}; host clock with sync); {card}")

    from highresnet_tpu_torch.registration.search import pcc_align_batch

    srs = torch.rand((8, 3 * FLAGSHIP["size"], 3 * FLAGSHIP["size"]),
                     generator=torch.Generator(device="cuda").manual_seed(5), device="cuda")
    anchor, members = srs[:1].repeat(7, 1, 1), srs[1:]
    with torch.inference_mode():
        align_ms = statistics.median(cuda_times_ms(lambda: pcc_align_batch(anchor, members), 20, 3))
    print(f"[flagship] x8 TTA's alignment alone (pcc_align_batch, 7 members of "
          f"{3 * FLAGSHIP['size']} px: FFTs, matrix-DFT zoom, one K3 warp): {align_ms:.3f} ms "
          f"(one call between two events, median of 20); {card}")

    for mode in ("tta8", "registered"):
        registered = mode == "registered"
        gpu, cpu = (flagship_model(cfg, runs, mode, d) for d in ("cuda", "cpu"))
        sr_gpu, score_gpu = gpu(batches[0], registered)
        sr_cpu, score_cpu = cpu(batches[0], registered)
        rel = float(np.max(np.abs(sr_gpu - sr_cpu)) / np.max(np.abs(sr_cpu)))
        d_db = abs(score_gpu - score_cpu)
        note = ""
        if rel > SR_RTOL:  # a PCC shift one zoom step apart moves a member's warp
            d_gpu, d_cpu = tta_member_shifts(gpu, batches[0]), tta_member_shifts(cpu, batches[0])
            apart = float(np.max(np.abs(d_gpu - d_cpu)))
            note = f"; members' PCC shifts differ by up to {apart:.4f} px"
            if mode != "tta8" or apart <= 1e-6:
                raise AssertionError(f"{mode}: GPU and CPU SR disagree with the same alignment")
        print(f"[flagship] {mode}, scene {batches[0].names[0]}, GPU vs CPU port: SR max|diff|/max|cpu| "
              f"{rel:.3e} (limit {SR_RTOL} where the alignment agrees{note}), shift-cPSNR "
              f"{score_gpu:.6f} vs {score_cpu:.6f} dB, |diff| {d_db:.2e} dB (limit {SCORE_ATOL_DB}); "
              f"{card}")
        if not (np.all(np.isfinite(sr_gpu)) and sr_gpu.shape == (3 * FLAGSHIP["size"],) * 2):
            raise AssertionError(f"{mode}: bad SR of shape {sr_gpu.shape}")
        if d_db > SCORE_ATOL_DB:
            raise AssertionError(f"{mode}: GPU and CPU scores of the port disagree")
    return totals


def phase_flagship(card: str, tmp: str) -> dict:
    """The measured-best recipe through the port on the card: the warm-start,
    the three chained stages, and cli.predict's serving paths; returns the
    kernel launches of the fused warm-start and the cli.train and
    cli.predict runs."""
    paths, runs = flagship_configs(tmp)
    warm = flagship_warmstart(paths[STAGES[0]], card)
    trained = flagship_train(paths, runs)
    flagship_step_time(paths[STAGES[0]], card)
    served = flagship_serve(paths, runs, card)
    return {k: warm[k] + trained[k] + served[k] for k in trained}


# [examples]: every quality-experiment driver at a smoke protocol on one set.
# The config arc (flagship_config_report.drive) trains each stage 10 epochs
# where the other drivers train 1: its control and ft_varl predict legs hold
# the contract that a trained checkpoint serves with no RuntimeWarning (the
# JAX arc, scripts/run_flagship_config.sh, trains configs/flagship*.json's
# full epochs first), and the overflow warning's 0.3 is calibrated between
# healthy checkpoints (0.11-0.26) and untrained ones (0.3-0.6,
# OVERFLOW_FRONTIER.json). A stage of 1 epoch from flax's init, the JAX
# package's, is still an untrained model by that calibration.
EXAMPLES = dict(scenes_per_channel=6, views=8, size=48, patch=32, batch=8, epochs=1,
                hr_shift_sigma=1.25, val_proportion=0.25, test_scenes_per_channel=2,
                max_scenes=3, warmup_steps=100, arc_epochs=10)
FRAC_WARP = (625, 144, 144)  # register_ablation's fractional search of one 48 px scene
# the kernels each driver must launch on the card (PERF.md's kernel table: K1
# every HRNet forward, K2 every training backward, K3 TTA/ensemble alignment
# and frac_cpsnr)
EXAMPLE_KERNELS = {
    "quality_experiment": ("pack", "unpack"),
    "quality_report": ("pack",),
    "test_model": ("pack",),
    "display_dataset": (),
    "views_ablation": ("pack",),
    "register_ablation": ("pack", "unpack", "lanczos"),
    "tta_experiment": ("pack", "lanczos"),
    "flagship_recipe": ("pack", "unpack", "lanczos"),
    "ensemble_experiment": ("pack", "unpack", "lanczos"),
    "recipe_report": (),
    "flagship_config_report": ("pack", "unpack", "lanczos"),  # drive trains the four arms
    "precision_ablation": ("pack",),
    "pipeline_bench": (),
}


def run_example(name: str, argv: list, runs: dict, summary, call=None) -> object:
    """One driver's main (or ``call()``, an entry point of its module) on the
    card with the launch counts set to 0 just before and read just after;
    TF32 must be off after it."""
    import importlib

    module = importlib.import_module(f"highresnet_tpu_torch.examples.{name}")
    reset_counts()
    t0 = time.perf_counter()
    out = call() if call is not None else module.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError(f"[examples] {name} left TF32 on")
    missing = [k for k in EXAMPLE_KERNELS[name] if counts[k] == 0]
    if missing:
        raise AssertionError(f"[examples] {name} launched no {missing}: {counts}")
    runs[name] = {"seconds": seconds, "counts": counts}
    print(f"[examples] {name}: {seconds:.1f} s, launches K1 {counts['pack']} K2 {counts['unpack']} "
          f"K3 {counts['lanczos']} K4 {counts['pack_dma']}; {summary(out)}", flush=True)
    return out


def examples_gpu_vs_cpu(config: dict, run_dir: str, root: str) -> None:
    """The scoring legs on the card against the port's CPU path on the same
    weights and draws, per scene within SCORE_ATOL_DB: MFSR / one view /
    bicubic, the views sweep, the TTA arms and frac_cpsnr."""
    from highresnet_tpu_torch.eval.evaluator import Forward, load_model
    from highresnet_tpu_torch.examples import register_ablation, tta_experiment, views_ablation
    from highresnet_tpu_torch.exp import harness

    val = harness.held_out_scenes(root, EXAMPLES["val_proportion"], EXAMPLES["max_scenes"])
    views = EXAMPLES["views"]
    legs = {}
    for device in ("cuda", "cpu"):
        fwd = Forward.plain(load_model(config, run_dir, device), torch.device(device), host=False)
        rows = harness.mfsr_rows(fwd, val, views, device)
        sweep = views_ablation.sweep(fwd, val, (1, 2, 4, views), device)
        tta_rows, _ = tta_experiment.run_split(fwd, val, views, len(val), "gpu-vs-cpu")
        _, frac = register_ablation.score_arm(fwd, val, views, device)
        legs[device] = {
            "mfsr": [r[k] for r in rows for k in ("mfsr", "one_view", "bicubic")],
            "views sweep": [x for k in sorted(sweep["per_k"]) for x in sweep["per_k"][k]]
            + sweep["bicubic"],
            "TTA rows": [r[a] for r in tta_rows for a in tta_experiment.ARMS],
            "frac_cpsnr": frac,
        }
    for leg, got in legs["cuda"].items():
        want = legs["cpu"][leg]
        err = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
        print(f"[examples] GPU vs CPU, {leg}: {len(got)} scores over {len(val)} scenes, "
              f"max|diff| {err:.2e} dB (limit {SCORE_ATOL_DB})")
        if not err <= SCORE_ATOL_DB:
            raise AssertionError(f"[examples] {leg}: GPU and CPU scores differ by {err} dB")


def examples_frac_warp(lanczos_fused, card: str) -> dict:
    """K3 at register_ablation's shape: one 48 px scene's SR (144 px) warped
    to the 625 placements of the 0.25 px grid over ±3 px, against the plain
    warp, its output in a NaN-filled block; timed as [warp] times K3. The
    SR goes in as frac_cpsnr passes it, expanded over the 625 placements
    (stride 0): the bound counts one image read and 625 written."""
    from highresnet_tpu_torch.examples.register_ablation import frac_grid

    g = torch.Generator(device="cuda").manual_seed(9)
    n, h, w = FRAC_WARP
    sr = torch.rand((h, w), generator=g, device="cuda")
    img = sr.expand(n, h, w)
    shift = frac_grid("cuda")
    address = poison(FRAC_WARP, torch.float32)
    got = lanczos_fused.lanczos_shift_cuda(img, shift)
    check_poisoned(got, address, f"lanczos_shift_cuda at {FRAC_WARP}")
    err = (got - lanczos_fused.lanczos_shift_ref(img, shift)).abs().max().item()
    if not err <= WARP_ATOL:
        raise AssertionError(f"lanczos kernel disagrees with its plain version at {FRAC_WARP}")
    t = graph_times_ms({"K3": lambda: lanczos_fused.lanczos_shift_cuda(img, shift),
                        "plain": lambda: lanczos_fused.lanczos_shift_ref(img, shift)})
    moved = (sr.numel() + img.numel()) * img.element_size() + shift.numel() * shift.element_size()
    flops = 2 * 2 * 7 * img.numel()
    bound = bound_ms(moved, flops)
    by = "bytes" if moved / HBM_BYTES_PER_S >= flops / F32_FLOPS else "operations"
    print(f"[examples] K3 at {FRAC_WARP} f32 (frac_cpsnr's 0.25 px grid over ±3 px, one SR "
          f"expanded), output in a "
          f"NaN-filled block: max|kernel - plain| {err:.3e} (limit {WARP_ATOL}); device time per "
          f"call (CUDA graph of {GRAPH_CALLS} calls, median of {GRAPH_REPLAYS} replays, in turns) "
          f"K3 {t['K3']:.4f} ms, plain {t['plain']:.4f} ms; bound {bound * 1e3:.3f} us "
          f"({moved / 1e6:.2f} MB; {by}, {bound / t['K3']:.1%} of it); {card}")
    return {"max_abs_err": err, "ms": t["K3"], "plain_ms": t["plain"], "bound_ms": bound,
            "bound_by": by}


def phase_examples(lanczos_fused, card: str, tmp: str) -> tuple[dict, dict]:
    """Every driver of highresnet_tpu_torch/examples/ at a smoke protocol on
    one synthetic misaligned set, through its own main(), at the production
    network's widths; the launches of each (counted per driver, asserted
    where the driver runs the kernel), TF32 off after each, the scoring legs
    GPU vs CPU, and K3 at frac_cpsnr's shape. Returns the summed launches
    and K3's reading at that shape."""
    import importlib.util

    from highresnet_tpu_torch.config import load_config
    from highresnet_tpu_torch.examples import flagship_config_report
    from highresnet_tpu_torch.exp import harness

    ex = EXAMPLES
    t_phase = time.perf_counter()
    root, out = os.path.join(tmp, "data"), os.path.join(tmp, "reports")
    harness.ensure_dataset(root, scenes_per_channel=ex["scenes_per_channel"], views=ex["views"],
                           lr_size=ex["size"], seed=0, detail=0.5,
                           hr_shift_sigma=ex["hr_shift_sigma"])
    print(f"[examples] smoke protocol, cut from each driver's defaults: one synthetic set of "
          f"{2 * ex['scenes_per_channel']} misaligned scenes (sigma {ex['hr_shift_sigma']} px, "
          f"{ex['views']} views of {ex['size']} px, made once, shared), {ex['epochs']} epoch a "
          f"run, batch {ex['batch']}, val {ex['val_proportion']}, at most {ex['max_scenes']} "
          f"scored scenes where a driver takes --max-scenes, a fresh test set of "
          f"{2 * ex['test_scenes_per_channel']} scenes; widths as shipped (64 channels, patch "
          f"{ex['patch']}, ShiftNet at register_size {2 * ex['patch']}); flagship_config_report's "
          f"arc (drive: cli.train and cli.predict in this process) at 1 epoch a stage, batch "
          f"{ex['batch']}, warm-start {ex['warmup_steps']} steps")
    common = ["--views", str(ex["views"]), "--device", "cuda"]
    train = ["--root", root, "--scenes-per-channel", str(ex["scenes_per_channel"]),
             "--lr-size", str(ex["size"]), "--epochs", str(ex["epochs"]),
             "--batch", str(ex["batch"]), "--patch", str(ex["patch"]), *common]
    runs = {}
    mean = lambda rows, k: float(np.mean([r[k] for r in rows]))

    q = run_example("quality_experiment", [*train, "--val-proportion", str(ex["val_proportion"]),
                                           "--out", f"{out}/QUALITY_REPORT.json"], runs,
                    lambda r: f"val mfsr {r['val_mean_shift_cpsnr']['mfsr']:.3f} dB, "
                              f"bicubic {r['val_mean_shift_cpsnr']['bicubic']:.3f}")
    run_dir = sorted(glob.glob(os.path.join(root, "ckpt", "*")))[-1]
    rows = run_example("quality_report", ["--data", root, "--checkpoint", run_dir, *common,
                                          "--val-proportion", str(ex["val_proportion"])], runs,
                       lambda rows: f"{len(rows)} scenes, mfsr {mean(rows, 'mfsr'):.3f} dB")
    if rows != q["per_scene"]:
        raise AssertionError("[examples] quality_report's rows differ from quality_experiment's "
                             "on the same run dir")
    cfg_path = os.path.join(tmp, "test_model.json")
    with open(cfg_path, "w") as f:
        json.dump({"paths": {"prefix": root},
                   "training": {"min_L": ex["views"], "n_views": ex["views"]}}, f)
    run_example("test_model", ["--config", cfg_path, "--checkpoint", run_dir, "--device", "cuda",
                               "--submission", os.path.join(tmp, "submission")], runs,
                lambda t: f"{len(t)} scenes scored, mean {t['model'].astype(float).mean():.3f} dB")
    if importlib.util.find_spec("matplotlib") is None:
        print("[examples] display_dataset: matplotlib is absent on this machine; the driver "
              "was not run and drew nothing")
    else:
        run_example("display_dataset", ["--data", root, "--out", os.path.join(tmp, "png"),
                                         "--n", "2"], runs,
                    lambda paths: f"matplotlib present, {len(paths)} PNGs written")
    run_example("views_ablation", ["--root", root, "--views", "1", "2", "4", str(ex["views"]),
                                   "--val-proportion", str(ex["val_proportion"]),
                                   "--device", "cuda", "--out", f"{out}/VIEWS_ABLATION.json"],
                runs, lambda r: "by views " + ", ".join(
                    f"{x['views']}: {x['mean_shift_cpsnr']:.3f}" for x in r["by_views"]))
    run_example("register_ablation", [*train, "--sigma", str(ex["hr_shift_sigma"]),
                                      "--val-proportion", str(ex["val_proportion"]),
                                      "--max-scenes", str(ex["max_scenes"]),
                                      "--out", f"{out}/REGISTER_ABLATION.json"], runs,
                lambda r: ", ".join(f"{k} {v['mean_shift_cpsnr']:.3f}/{v['mean_fractional_cpsnr']:.3f}"
                                    for k, v in r["protocols"][-1]["arms"].items())
                + " dB (integer/fractional)")
    run_example("tta_experiment", ["--root", root, "--run", run_dir, "--batch", "3",
                                   "--val-proportion", str(ex["val_proportion"]),
                                   "--splits", "val", *common, "--out", f"{out}/TTA_REPORT.json"],
                runs, lambda r: f"val {r['val_split']['mean_shift_cpsnr']}")
    run_example("flagship_recipe", [*train, "--test-root", os.path.join(tmp, "test"),
                                    "--test-scenes-per-channel", str(ex["test_scenes_per_channel"]),
                                    "--sigma", str(ex["hr_shift_sigma"]),
                                    "--out", f"{out}/FLAGSHIP_RECIPE.json"], runs,
                lambda r: "comparisons " + ", ".join(
                    f"{k} {v['mean_db']:+.3f} dB" for k, v in r["comparisons"].items()))
    run_example("ensemble_experiment", [*train, "--seeds", "0,1", "--tta", "8",
                                        "--val-proportion", str(ex["val_proportion"]),
                                        "--max-scenes", str(ex["max_scenes"]),
                                        "--out", f"{out}/ENSEMBLE_REPORT.json"], runs,
                lambda r: f"ensemble - best single {r['ensemble_minus_best_single_db']:+.3f} dB, "
                          f"full stack - best single {r['full_stack_minus_best_single_db']:+.3f}")
    run_example("recipe_report", ["--baseline", str(REPO / "RECIPE_FT_CTL.json"), "--candidate",
                                  str(REPO / "RECIPE_FT_RP30.json"),
                                  "--out", f"{out}/RECIPE_REPORT.json"], runs,
                lambda r: f"{len(r['candidates'])} candidate against the checked-in baseline")

    run_example("flagship_config_report", [], runs,
                lambda r: "comparisons " + ", ".join(
                    f"{k} {v['mean_db']:+.3f} dB" for k, v in r["comparisons"].items())
                + f"; recommended-flow RuntimeWarnings {r['runtime_warnings_recommended_flow']}",
                call=lambda: flagship_config_report.drive(
                    os.path.join(tmp, "arc"), "cuda", f"{out}/FLAGSHIP_CONFIG_DRIVE.json",
                    configs_dir=str(REPO / "configs"),
                    scenes_per_channel=ex["scenes_per_channel"], lr_size=ex["size"],
                    overrides={"training": {"num_epochs": ex["arc_epochs"],
                                            "batch_size": ex["batch"]}},
                    warmup_steps=ex["warmup_steps"]))
    run_example("precision_ablation", ["--device", "cuda",
                                       "--out", f"{out}/PRECISION_ABLATION.json"], runs,
                lambda r: "rms vs f32 " + ", ".join(
                    f"{k} {v['rms_vs_f32']:.3e}" for k, v in r["variants"].items())
                + f"; 50 dB delta bf16 {r['variants']['bf16']['delta_db_at_50db']:.4f}")
    run_example("pipeline_bench", ["--root", os.path.join(tmp, "pipe"), "--scenes", "8",
                                   "--views", str(ex["views"]), "--lr-size", str(ex["size"]),
                                   "--patch", str(ex["patch"]), "--epochs", "1", "--workers", "2",
                                   "--out", f"{out}/PIPELINE_BENCH.json"], runs,
                lambda r: f"scenes/s png {r['png_scenes_per_sec']}, packed "
                          f"{r['packed_scenes_per_sec']}, cache {r['cache_scenes_per_sec']} "
                          f"(host, {r['protocol']['host_cores']} cores)")

    config = load_config(overrides={"training": {"min_L": ex["views"], "n_views": ex["views"]}})
    examples_gpu_vs_cpu(config, run_dir, root)
    frac = examples_frac_warp(lanczos_fused, card)
    total = {k: sum(r["counts"][k] for r in runs.values()) for k in read_counts()}
    print(f"[examples] {len(runs)} drivers in {time.perf_counter() - t_phase:.1f} s (phase), "
          f"launches summed K1 {total['pack']} K2 {total['unpack']} K3 {total['lanczos']}; "
          f"quality_experiment's report: {q['scenes_where_mfsr_beats_bicubic']} scenes where "
          f"mfsr beats bicubic; {card}")
    return total, frac


# [registration]: the toolkit on a 384 px HR-sized frame at the JAX defaults
REG = dict(size=384, shift=(0.7, -0.4), border=4, points_per_dim=7, max_recursions=10,
           candidates=49, pm_scale=2, reps=3)
REG_PL_CPU = dict(size=64, points_per_dim=3, max_recursions=3)  # VGG19 at 384 px is too slow for a CPU
# |recovered - truth| limits per method, px, set before the first run: the
# JAX tests' 0.06 for the smooth-metric searches, looser for the binned MI
# and the pixel-quantised ORB keypoints, 0.01 for PCC on an exact Fourier shift
REG_LIMITS_PX = {"Fourier": 0.01, "Point Matching": 0.5, "NCC": 0.06, "Perceptual Loss": 0.06,
                 "SSIM": 0.06, "Mutual Information": 0.25, "Mean L1 Error": 0.06}
REG_GPU_CPU_PX = 0.01  # each method's shift, GPU vs the port's CPU path
REG_METRIC_RTOL = 1e-4  # each recorded metric, GPU vs CPU
METRIC_KEYS = ("ml1e", "pl", "ssim", "nmi", "ncc")


def registration_pair(size: int, seed: int = 0) -> dict:
    """A seeded smooth field, its template shifted by REG["shift"] (scipy,
    order 3), a 4 px border mask on both and a cloud blob masked out of the
    reference."""
    from scipy.ndimage import gaussian_filter, shift as ndi_shift

    rng = np.random.default_rng(seed)
    field = gaussian_filter(np.kron(rng.random((size // 4, size // 4)), np.ones((4, 4))), 2.0)
    field = ((field - field.min()) / (field.max() - field.min())).astype(np.float32)
    template = ndi_shift(field, REG["shift"], mode="constant", order=3).astype(np.float32)
    border = np.zeros((size, size), np.float32)
    b = REG["border"]
    border[b:-b, b:-b] = 1.0
    clouds = gaussian_filter(rng.standard_normal((size, size)), size / 24)
    ref_mask = border * (clouds < np.quantile(clouds, 0.85))
    return dict(ref=field, template=template, ref_mask=ref_mask.astype(np.float32),
                template_mask=border)


def fourier_pair(size: int, seed: int = 7) -> dict:
    """A broadband image and its exact Fourier-domain shift by REG["shift"]."""
    rng = np.random.default_rng(seed)
    img = rng.random((size, size))
    fy = np.fft.fftfreq(size)[:, None]
    fx = np.fft.fftfreq(size)[None, :]
    dy, dx = REG["shift"]
    moved = np.real(np.fft.ifft2(np.fft.fft2(img) * np.exp(-2j * np.pi * (fy * dy + fx * dx))))
    ones = np.ones((size, size), np.float32)
    return dict(ref=img.astype(np.float32), template=moved.astype(np.float32), ref_mask=ones,
                template_mask=ones)


def method_kwargs(method: str, pl_cut: bool = False) -> dict:
    if method == "Point Matching":
        return {"scale": REG["pm_scale"]}
    if method == "Fourier":
        return {}
    if pl_cut:
        return {k: REG_PL_CPU[k] for k in ("points_per_dim", "max_recursions")}
    return {"points_per_dim": REG["points_per_dim"], "max_recursions": REG["max_recursions"]}


def solve(method: str, pair: dict, device: str, extractor, **kwargs):
    """A fresh session on ``device`` solves ``pair`` with ``method``; returns it."""
    from highresnet_tpu_torch.registration.session import RegistrationSession

    session = RegistrationSession(device=device, perceptual_model=extractor)
    session.set_arrays(pair["ref"], pair["template"], pair["ref_mask"], pair["template_mask"])
    session.compute_and_apply_shift(method, **kwargs)
    return session


def session_ms(session, method: str, **kwargs) -> float:
    """Host ms per compute_and_apply_shift (record_metrics included), card
    drained before and after, from the zero shift each time; median of
    REG["reps"] (the session's first solve is the warm-up)."""
    times = []
    for _ in range(REG["reps"]):
        session.config["current_deltay"] = session.config["current_deltax"] = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.compute_and_apply_shift(method, **kwargs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def vgg_flops(size: int) -> float:
    """Operations of one VGG19 forward to conv 28 on a size x size image."""
    from highresnet_tpu_torch.models.vgg import _VGG19_PLAN

    flops, in_ch = 0.0, 3
    for item in _VGG19_PLAN:
        if item == "M":
            size //= 2
            continue
        flops += 2.0 * size * size * in_ch * item[0] * 9
        in_ch = item[0]
    return flops


def registration_timings(pairs: dict, extractor, card: str) -> None:
    """ms per compute_and_apply_shift of each method, per grid level of NCC
    and PL (CUDA events), and features_batched over 49 x 384 px."""
    from highresnet_tpu_torch.registration import search as rs
    from highresnet_tpu_torch.registration.session import SEARCH_METHODS
    from highresnet_tpu_torch.runtime import as_tensor

    per_method = {}
    for method in SEARCH_METHODS:
        pair = pairs["fourier" if method == "Fourier" else "smooth"]
        session = solve(method, pair, "cuda", extractor, **method_kwargs(method))
        per_method[method] = session_ms(session, method, **method_kwargs(method))
    print(f"[registration] ms per compute_and_apply_shift at {REG['size']} px (host clock, card "
          f"drained, record_metrics included, median of {REG['reps']} after the first solve): "
          + ", ".join(f"{m} {ms:.3f}" for m, ms in per_method.items()) + f"; {card}")

    p = pairs["smooth"]
    ref, rmask, tpl, tmask = (as_tensor(p[k], "cuda") for k in
                              ("ref", "ref_mask", "template", "template_mask"))
    center = torch.zeros(2, device="cuda")
    ppd = REG["points_per_dim"]
    levels = {
        "NCC": lambda: torch.argmax(rs._mncc_grid_scores(ref, rmask, tpl, tmask, center, 2.0, ppd)[1]),
        "PL": lambda: torch.argmin(rs._pl_grid_scores(extractor, ref, rmask, tpl, tmask, center,
                                                      2.0, ppd)[1]),
    }
    level_ms = {name: statistics.median(cuda_times_ms(fn, REG["reps"], 1))
                for name, fn in levels.items()}
    stack = tpl[None].expand(REG["candidates"], -1, -1).contiguous()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    vgg_ms = statistics.median(cuda_times_ms(lambda: extractor.features_batched(stack),
                                             REG["reps"], 1))
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    flops = REG["candidates"] * vgg_flops(REG["size"])
    print(f"[registration] one grid level ({ppd}x{ppd} = {ppd * ppd} candidates, warp + score + "
          f"argmax, CUDA events, median of {REG['reps']}): NCC {level_ms['NCC']:.3f} ms, PL "
          f"{level_ms['PL']:.3f} ms; features_batched over {REG['candidates']} x {REG['size']} px: "
          f"{vgg_ms:.3f} ms, {flops / 1e12:.3f} TFLOP, {flops / vgg_ms / 1e9:.1f} TFLOP/s, bound "
          f"{flops / F32_FLOPS * 1e3:.3f} ms at the f32 peak, peak memory {peak_gib:.2f} GiB "
          f"above the {base / 2**30:.2f} GiB held before; {card}")


def registration_histogram(pair: dict) -> None:
    """The MI joint histogram under deterministic algorithms on the card:
    bincount without weights runs and equals the CPU's counts; whether
    histc and a weighted bincount refuse is printed."""
    from highresnet_tpu_torch.registration import metrics as rm

    if not torch.are_deterministic_algorithms_enabled():
        raise AssertionError("[registration] expected deterministic algorithms to be on")
    args = [pair[k] for k in ("ref", "template", "ref_mask", "template_mask")]
    gpu = rm.joint_counts(*args, device="cuda")
    cpu = rm.joint_counts(*args, device="cpu")
    if not torch.equal(gpu.cpu(), cpu):
        raise AssertionError("[registration] MI joint counts differ between GPU and CPU")
    refused = {}
    x = torch.zeros(4, device="cuda")
    for name, fn in (("torch.histc", lambda: torch.histc(x, bins=4)),
                     ("weighted torch.bincount", lambda: torch.bincount(x.long(), weights=x))):
        try:
            fn()
            refused[name] = "runs"
        except RuntimeError as e:
            refused[name] = f"raises ({str(e).splitlines()[0][:60]})"
    print(f"[registration] deterministic mode on: MI joint histogram by bincount (no weights) "
          f"ran on the card, {int(gpu.sum())} counts equal to the CPU's; on CUDA "
          + "; ".join(f"{k} {v}" for k, v in refused.items()))


def phase_registration(card: str, tmp: str) -> None:
    """The registration toolkit through RegistrationSession on the card: every
    search method against a known shift, the metrics, vote, overlays and
    heatmap; the same calls on the CPU path; preprocess_imgset on a
    synthetic scene; timings. No kernel of K1-K4 runs here."""
    from highresnet_tpu_torch.data import make_synthetic_dataset
    from highresnet_tpu_torch.models.vgg import VGGFeatureExtractor
    from highresnet_tpu_torch.registration.preprocess import preprocess_imgset
    from highresnet_tpu_torch.registration.session import OVERLAY_MODES, SEARCH_METHODS

    pairs = {"smooth": registration_pair(REG["size"]), "fourier": fourier_pair(REG["size"])}
    pl_pair = registration_pair(REG_PL_CPU["size"])
    extractors = {d: VGGFeatureExtractor(seed=0, device=d) for d in ("cuda", "cpu")}
    truth = tuple(-v for v in REG["shift"])  # the shift that aligns the template
    registration_histogram(pairs["smooth"])

    for method in SEARCH_METHODS:
        pair = pairs["fourier" if method == "Fourier" else "smooth"]
        t0 = time.perf_counter()
        gpu = solve(method, pair, "cuda", extractors["cuda"], **method_kwargs(method))
        gpu_s = time.perf_counter() - t0
        err = max(abs(a - b) for a, b in zip(gpu.current_shift, truth))
        print(f"[registration] {method} at {REG['size']} px on the card: shift "
              f"({gpu.current_shift[0]:+.5f}, {gpu.current_shift[1]:+.5f}) vs truth "
              f"({truth[0]:+.5f}, {truth[1]:+.5f}), max error {err:.5f} px (limit "
              f"{REG_LIMITS_PX[method]}), first call {gpu_s:.2f} s; {card}")
        if not err <= REG_LIMITS_PX[method]:
            raise AssertionError(f"[registration] {method} missed the known shift")
        if method == "Perceptual Loss":  # GPU vs CPU at the cut size
            pair = pl_pair
            gpu = solve(method, pair, "cuda", extractors["cuda"], **method_kwargs(method, True))
        cpu = solve(method, pair, "cpu", extractors["cpu"],
                    **method_kwargs(method, method == "Perceptual Loss"))
        d_px = max(abs(a - b) for a, b in zip(gpu.current_shift, cpu.current_shift))
        # metrics at one shift: MI jumps between shifts 1e-3 px apart
        cpu.config["current_deltay"], cpu.config["current_deltax"] = gpu.current_shift
        cpu.record_metrics()
        rels = {k: abs(gpu.history[k][0] - cpu.history[k][-1]) / abs(cpu.history[k][-1])
                for k in METRIC_KEYS}
        rel = max(rels.values())
        size = REG_PL_CPU["size"] if method == "Perceptual Loss" else REG["size"]
        print(f"[registration] {method} GPU vs CPU port at {size} px: shift |diff| {d_px:.2e} px "
              f"(limit {REG_GPU_CPU_PX}); metrics recorded at the GPU's shift, max rel diff "
              f"{rel:.2e} ({max(rels, key=rels.get)}; limit {REG_METRIC_RTOL}): "
              + ", ".join(f"{k} {gpu.history[k][0]:.6f}" for k in METRIC_KEYS))
        if not (d_px <= REG_GPU_CPU_PX and rel <= REG_METRIC_RTOL):
            raise AssertionError(f"[registration] {method}: GPU and CPU paths disagree")

    session = solve("NCC", pairs["smooth"], "cuda", extractors["cuda"], **method_kwargs("NCC"))
    best = session.current_shift
    session.nudge(dy=0.5, dx=-0.25)
    session.record_metrics()
    voted = session.vote_best_shift()
    overlays = {mode: session.overlay(mode) for mode in OVERLAY_MODES}
    heatmap = session.vgg_diff_heatmap()
    tensors = [session.ref_image, session.ref_mask, session.template_image,
               session.template_mask, *session.shifted_template()]
    if not all(t.device.type == "cuda" for t in tensors):
        raise AssertionError("[registration] the session's tensors left the card")
    if voted != best:
        raise AssertionError(f"[registration] vote chose {voted}, not the solved shift {best}")
    if not all(o.dtype == np.uint8 and o.shape[:2] == (REG["size"],) * 2 for o in overlays.values()):
        raise AssertionError("[registration] bad overlay")
    if not (heatmap.ndim == 2 and np.all(np.isfinite(heatmap))):
        raise AssertionError("[registration] bad VGG diff heatmap")
    print(f"[registration] record_metrics after a nudge, vote -> {voted} (the solved shift), "
          f"{len(overlays)} overlays uint8, heatmap {heatmap.shape} finite; images, masks and "
          f"the shifted template on {session.ref_image.device}")

    root = make_synthetic_dataset(os.path.join(tmp, "data"), n_scenes_per_channel=1, n_views=16,
                                  lr_size=128, seed=0, splits=("train",))
    scene = os.path.join(root, "train", sorted(os.listdir(os.path.join(root, "train")))[0])
    scene = os.path.join(scene, sorted(os.listdir(scene))[0])
    t0 = time.perf_counter()
    on_card = preprocess_imgset(scene, out_subdir="aligned_cuda", device="cuda")
    card_s = time.perf_counter() - t0
    on_cpu = preprocess_imgset(scene, out_subdir="aligned_cpu", device="cpu")
    d_px = max(abs(a - b) for k in on_card for a, b in zip(on_card[k], on_cpu[k]))
    written = sorted(os.listdir(os.path.join(scene, "aligned_cuda")))
    want = ["REF.png"] + [f"{p}{i:03d}.{e}" for p, e in (("LR", "png"), ("QM", "png"),
                                                         ("shift", "json")) for i in range(16)]
    print(f"[registration] preprocess_imgset on {os.path.basename(scene)} (16 views of 128 px, "
          f"HR 384 px): {len(on_card)} shifts on the card in {card_s:.2f} s, GPU vs CPU max "
          f"|diff| {d_px:.2e} px (limit {REG_GPU_CPU_PX}); {len(written)} files written; {card}")
    if sorted(want) != written or d_px > REG_GPU_CPU_PX:
        raise AssertionError("[registration] preprocess_imgset: files or shifts wrong")

    registration_timings(pairs, extractors["cuda"], card)


# [bench]: highresnet_tpu_torch.bench's main in-process, every row at its full
# shape, BENCH_ITERS calls a window and one window a row (the bench's own
# windows and three repeats run in its own call: python -m
# highresnet_tpu_torch.bench)
BENCH_ITERS, BENCH_REPEATS = 2, 1
BENCH_PHASE_LIMIT_S = 150.0
BENCH_NUMBERS = ("first_call_s", "step_time_s", "scenes_per_sec", "achieved_tflops_per_s",
                 "utilization", "peak_memory_gb")


def bench_launches(row, repeats: int, iters: int) -> dict:
    """K1 and K2 launches a bench row makes: one K1 per fusion round of each
    forward, one K2 per round of each train step's backward; the calls are
    the first, then a warm-up and the window per repeat (twice as long on a
    re-measure)."""
    calls = 1 + repeats * (1 + iters)
    if row.get("remeasured_wider_window"):
        calls += repeats * (1 + 2 * iters)
    rounds = int(math.log2(row["views"]))
    return {"pack": calls * rounds, "unpack": calls * rounds if row["kind"] == "train_step" else 0}


def phase_bench(card: str, tmp: str) -> dict:
    """The bench's rows at full shape on the card through ``bench.main``;
    every row present, finite and positive, none still ``timing_suspect``,
    the bf16 train step's state f32, K1/K2 launches as the rows imply and no
    K3 or K4; returns the launch counts and the rows."""
    from highresnet_tpu_torch import bench

    out = os.path.join(tmp, "BENCH_DETAILS.json")
    stdout = io.StringIO()
    t0 = time.perf_counter()
    reset_counts()
    with contextlib.redirect_stdout(stdout):
        details = bench.main(["--out", out], iters=BENCH_ITERS, repeats=BENCH_REPEATS)
    counts = read_counts()
    wall = time.perf_counter() - t0
    rows = details["configs"]
    line = json.loads(stdout.getvalue().strip().splitlines()[-1])
    print(f"[bench] the bench's line: {json.dumps(line)}")
    if set(line) != {"metric", "value", "unit", "vs_baseline"} or not line["value"] > 0:
        raise AssertionError(f"[bench] bad headline line {line}")
    if [r["name"] for r in rows] != [r.name for r in bench.ROWS]:
        raise AssertionError(f"[bench] rows {[r['name'] for r in rows]}, expected every row")
    want = {"pack": 0, "unpack": 0, "lanczos": 0, "pack_dma": 0}
    for row in rows:
        if "error" in row:
            raise AssertionError(f"[bench] {row['name']} failed: {row['error']}")
        size = f"patch {row['patch']}" if "patch" in row else f"{row['lr_size']} px"
        extra = ""
        if row["kind"] == "train_step":
            extra = (f", last loss {row['last_loss']:.6g}, max |shift| "
                     f"{row['max_abs_shift']:.4g} px, init {row['init_time_s']:.3f} s, "
                     f"state {row['state_dtypes']}")
        print(f"[bench] {row['name']}: batch {row['batch']} x {row['views']} views x {size} "
              f"{row['dtype']}: {row['step_time_s'] * 1e3:.3f} ms a step, "
              f"{row['scenes_per_sec']:.3f} scenes/s, {row['achieved_tflops_per_s']} TFLOP/s, "
              f"utilization {row['utilization']}, peak {row['peak_memory_gb']:.2f} GB, first "
              f"call {row['first_call_s']:.3f} s, launches {row['launches']}{extra}; {card}")
        bad = [k for k in BENCH_NUMBERS if not (isinstance(row.get(k), (int, float))
                                                and math.isfinite(row[k]) and row[k] > 0)]
        if bad or row.get("timing_suspect"):
            raise AssertionError(f"[bench] {row['name']}: non-finite or non-positive {bad}, "
                                 f"or still timing_suspect: {row}")
        if row["kind"] == "train_step" and row["state_dtypes"] != {
                k: ["float32"] for k in ("params", "grads", "adam_moments")}:
            raise AssertionError(f"[bench] {row['name']}: state not f32: {row['state_dtypes']}")
        implied = bench_launches(row, BENCH_REPEATS, BENCH_ITERS)
        if row["launches"] != implied:
            raise AssertionError(f"[bench] {row['name']}: launches {row['launches']}, "
                                 f"expected {implied}")
        for k, n in implied.items():
            want[k] += n
    # in-process the bench's clock starts at its import, during [pack]: its
    # process-start figure is the bench's own only when run as a program
    startup = {k: v for k, v in details["startup"].items()
               if k not in ("what", "process_start_to_first_step_s")}
    print(f"[bench] startup (the build, the f32 train row's init and first step) "
          f"{json.dumps(startup)}")
    print(f"[bench] launches {counts} (expected {want}); {len(rows)} rows, {BENCH_ITERS} calls "
          f"a window, {BENCH_REPEATS} window a row; phase wall {wall:.1f} s (limit "
          f"{BENCH_PHASE_LIMIT_S:.0f}); {card}")
    if counts != want or not (counts["pack"] > 0 and counts["unpack"] > 0):
        raise AssertionError("[bench] the kernels' launches differ from the rows'")
    if wall > BENCH_PHASE_LIMIT_S:
        raise AssertionError(f"[bench] the phase took {wall:.1f} s")
    return counts, rows


# [labs]: the perf labs at the JAX labs' default shapes, LABS_ITERS calls a
# timing after LABS_WARMUP, the trace over LABS_TRACE_STEPS steps
LABS_ITERS, LABS_WARMUP, LABS_TRACE_STEPS = 2, 1, 2
# a variant against its control in f32, TF32 off: other sums, other algorithms
LABS_F32_RTOL = 1e-4
LABS_TRACE_RTOL = 0.10  # the trace's device ms a step against [bench]'s window
LABS_CATEGORY_RTOL = 0.01  # the categories' sum against the device total
LABS_PHASE_LIMIT_S = 150.0


def labs_launches(name: str, report: dict) -> dict:
    """K1 and K2 launches a lab's run implies: one K1 per fusion round of
    each FusionNet call (and per pack call), one K2 per round of each train
    step's backward; every timing is ``warmup + iters`` calls."""
    calls = report.get("warmup", 0) + report.get("iters", 0)
    rounds = int(math.log2(report["views"]))
    if name.startswith("fusion_lab "):  # v0 timed, then once against v1/v2
        return {"pack": rounds * (calls + 1), "unpack": 0}
    if name == "fusion_lab2":  # p_concat and full_v0 timed, full_v0 once against v3
        return {"pack": rounds * (2 * calls + 1), "unpack": 0}
    if name == "fusion_lab3":  # the pack timed and compared; gated and no-gate fusion timed
        return {"pack": calls + 1 + 2 * rounds * calls, "unpack": 0}
    if name == "bench_breakdown":  # per dtype: the forward and the fusion stage timed, one fuse
        return {"pack": len(report["stages"]) * rounds * (2 * calls + 1), "unpack": 0}
    steps = report["steps_run"]  # a trace: every step one forward and one backward
    return {"pack": rounds * steps, "unpack": rounds * steps}


def phase_labs(fusion, card: str, tmp: str, bench_rows_run: list) -> dict:
    """The five labs on the card through their ``main``; returns their K1/K2
    launches (the NaN-block check of K1 at fusion_lab3's shape comes after
    the counts are read)."""
    from highresnet_tpu_torch.labs import (
        bench_breakdown,
        fusion_lab,
        fusion_lab2,
        fusion_lab3,
        trace_train_step,
    )

    t0 = time.perf_counter()
    window = ["--device", "cuda", "--iters", str(LABS_ITERS), "--warmup", str(LABS_WARMUP)]
    out = lambda name: ["--out", os.path.join(tmp, f"{name.replace(' ', '_')}.json")]  # noqa: E731
    breakdown_out = out("bench_breakdown")
    runs = [(f"fusion_lab {dtype}", fusion_lab, ["--dtype", dtype])
            for dtype in ("float32", "bfloat16")]
    runs += [("fusion_lab2", fusion_lab2, []), ("fusion_lab3", fusion_lab3, []),
             ("bench_breakdown", bench_breakdown, [])]
    reports = {}
    reset_counts()
    for name, lab, argv in runs:
        before = read_counts()
        reports[name] = lab.main([*window, *out(name), *argv])
        torch.cuda.empty_cache()
        print(f"[labs] {name}: {json.dumps(reports[name])}; {card}")
        check_lab_launches(name, reports[name], before)
    for dtype in ("float32", "bfloat16"):
        name = f"trace {dtype}"
        before = read_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            reports[name] = trace_train_step.main([
                "--device", "cuda", "--dtype", dtype, "--steps", str(LABS_TRACE_STEPS),
                *out(name), "--trace-dir", os.path.join(tmp, f"{dtype}_train"),
                "--breakdown", breakdown_out[1]])
        torch.cuda.empty_cache()
        print(f"[labs] {name}: " + json.dumps(
            {k: v for k, v in reports[name].items() if k != "top_ops"}) + f"; {card}")
        check_lab_launches(name, reports[name], before)
    counts = read_counts()
    wall = time.perf_counter() - t0

    for dtype in ("float32", "bfloat16"):
        f = reports[f"fusion_lab {dtype}"]
        for key, scale in (("v1_max_abs_diff", f["fusion"]["v0_max_abs"]),
                           ("v2_max_abs_diff", f["fusion"]["v0_max_abs"]),
                           ("d1_max_abs_diff", f["decoder"]["d0_max_abs"])):
            check_variant(f"fusion_lab {dtype} {key}", {**f["fusion"], **f["decoder"]}[key],
                          scale, dtype)
    lab2 = reports["fusion_lab2"]
    check_variant("fusion_lab2 v3_max_abs_diff", lab2["v3_max_abs_diff"], lab2["v0_max_abs"],
                  lab2["dtype"])
    lab3 = reports["fusion_lab3"]
    if lab3["pack_equal"] is not True:
        raise AssertionError("[labs] fusion_lab3: K1's pack differs from pack_pairs_ref")
    for probe in ("bw_c64", "bw_c128", "bw_concat64"):
        p = lab2[probe]
        print(f"[labs] fusion_lab2 {probe}: {p['gb_per_s']:.1f} GB/s, {p['share_of_hbm']:.1%} of "
              f"3.35 TB/s; {card}")
    for dtype, row in reports["bench_breakdown"]["stages"].items():
        times = {k: v for k, v in row.items() if k.endswith("_s")}
        if not all(math.isfinite(v) and v > 0 for v in times.values()):
            raise AssertionError(f"[labs] bench_breakdown {dtype}: bad stage times {times}")
        print(f"[labs] bench_breakdown {dtype}: stage sum / full forward "
              f"{row['stage_sum_s'] / row['full_forward_s']:.3f}; conv64_stack "
              f"{row['conv64_stack']['tflops_per_s']:.2f} TFLOP/s, conv128_stack "
              f"{row['conv128_stack']['tflops_per_s']:.2f}; {card}")

    bench_ms = {row["dtype"]: row["step_time_s"] * 1e3 for row in bench_rows_run
                if row["kind"] == "train_step"}
    for dtype in ("float32", "bfloat16"):
        t = reports[f"trace {dtype}"]
        cats = t["category_accounting_ms_per_step"]
        total = t["device_ms_per_step"]
        print(f"[labs] trace {dtype}: device {total:.3f} ms a step (the bench's window "
              f"{bench_ms[dtype]:.3f}, the lab's own {t['window_ms_per_step']:.3f}), idle share "
              f"{t['idle_share']:.4f}, 'other' {t['other_share']:.2%}, categories "
              f"{json.dumps(cats)}, loss finite {t['loss_finite']} ({t['last_loss']:.6g}); "
              f"ceiling: {t['ceiling_accounting']['text']}; {card}")
        for row in t["top_ops"][:10]:
            print(f"[labs] trace {dtype} top op: {row['us_per_step']:.1f} us a step "
                  f"({row['pct']:.2f}%, x{row['count_per_step']:g}) [{row['category']}] "
                  f"{row['op'][:160]}")
        if not cats[trace_train_step.PORT] > 0:
            raise AssertionError(f"[labs] trace {dtype}: K1/K2 launched, no port kernel traced")
        if abs(sum(cats.values()) - total) > LABS_CATEGORY_RTOL * total:
            raise AssertionError(f"[labs] trace {dtype}: categories sum to {sum(cats.values())}, "
                                 f"device total {total}")
        if abs(total - bench_ms[dtype]) > LABS_TRACE_RTOL * bench_ms[dtype]:
            raise AssertionError(f"[labs] trace {dtype}: {total:.3f} ms a step on the device, "
                                 f"the bench's window {bench_ms[dtype]:.3f}")

    # K1 at fusion_lab3's pack shape against the plain version, its output in a
    # NaN-filled block (after the counts: a check's launch is not the lab's)
    g = torch.Generator(device="cuda").manual_seed(0)
    b, l, c, s = (lab3[k] for k in ("batch", "views", "channels", "size"))
    x = torch.randn((b, l, c, s, s), generator=g, device="cuda").to(torch.bfloat16)
    address = poison((b, l // 2, 2 * c, s, s), torch.bfloat16)
    got = fusion_lab3.ROUTES["pack_pallas"](x)
    check_poisoned(got, address, "[labs] fusion_lab3's K1")
    if not torch.equal(got, fusion_lab3.ROUTES["pack_xla"](x)):
        raise AssertionError("[labs] fusion_lab3's K1 != pack_pairs_ref in a NaN-filled block")
    write_counts(counts)
    print(f"[labs] fusion_lab3's K1 at {tuple(x.shape)} bf16, output in a NaN-filled block: "
          f"torch.equal to pack_pairs_ref True")
    print(f"[labs] launches {counts}; phase wall {wall:.1f} s (limit "
          f"{LABS_PHASE_LIMIT_S:.0f}); {card}")
    if counts["lanczos"] or counts["pack_dma"] or not (counts["pack"] and counts["unpack"]):
        raise AssertionError(f"[labs] launches {counts}")
    if wall > LABS_PHASE_LIMIT_S:
        raise AssertionError(f"[labs] the phase took {wall:.1f} s")
    return counts


def check_lab_launches(name: str, report: dict, before: dict) -> None:
    got = {k: v - before[k] for k, v in read_counts().items()}
    want = {**labs_launches(name, report), "lanczos": 0, "pack_dma": 0}
    print(f"[labs] {name}: launches {got} (expected {want})")
    if got != want or {k: got[k] for k in report["launches"]} != report["launches"]:
        raise AssertionError(f"[labs] {name}: launches {got}, expected {want}, the lab's own "
                             f"{report['launches']}")


def check_variant(what: str, diff: float, scale: float, dtype: str) -> None:
    limit = (LABS_F32_RTOL if dtype == "float32" else BF16_MAX) * scale
    print(f"[labs] {what} {diff:.4e} (limit {limit:.4e} of max|control| {scale:.4f})")
    if not diff <= limit:
        raise AssertionError(f"[labs] {what} {diff} past {limit}")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this script needs one NVIDIA GPU")
    if sys.argv[1:2] == ["--dist-rank"]:  # one rank of [dist], started by phase_dist
        rank, world, cfg_path, run_dir, out_path = sys.argv[2:7]
        dist_child(int(rank), int(world), cfg_path, run_dir, out_path)
        return
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
        "attend": phase_trmisr(card),
    }
    predicted = phase_predict(fusion, lanczos_fused, card)
    phase_forward(card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        trained = phase_train(fusion, lanczos_fused, card, tmp)
        phase_train_step(card, tmp)
        distributed, oracle_data2, floor_data2 = phase_dist(card, tmp)
        viewed = phase_view(card, tmp, oracle_data2, floor_data2)
        optioned = phase_options(card, tmp)
    dma = phase_dma(fusion, fusion_dma, card)
    measured["pack"].update(dma["pack"])
    measured["pack_dma"] = dma["pack_dma"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lab4_") as tmp:
        lab = phase_lab4(fusion, lanczos_fused, card, tmp)
    phase_fills(fusion, fusion_dma, lanczos_fused)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_flagship_") as tmp:
        flagship = phase_flagship(card, tmp)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp:
        examples, frac_warp = phase_examples(lanczos_fused, card, tmp)
    measured["lanczos"]["serving"][str(FRAC_WARP)] = frac_warp
    before = read_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_registration_") as tmp:
        phase_registration(card, tmp)
    if read_counts() != before:
        raise AssertionError(f"[registration] launched a kernel: {before} -> {read_counts()}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bench_") as tmp:
        benched, bench_rows_run = phase_bench(card, tmp)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_labs_") as tmp:
        labs = phase_labs(fusion, card, tmp, bench_rows_run)

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
        "launches": (predicted[key] + trained[key] + distributed[key] + viewed[key]
                     + optioned[key] + lab[key] + flagship[key] + examples[key] + benched[key]
                     + labs[key]),
        **measured[key],
    } for key, (name, src, replaces) in sources.items()]
    kernels.append({"name": "attend", "route": "cuda",
                    "source": "highresnet_tpu_torch/csrc/attend.cu", "replaces": None,
                    **measured["attend"]})  # K5 launches in [trmisr]'s forward alone
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
