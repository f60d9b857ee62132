"""Multi-head attention over short sequences: TR-MISR's fusion core.

Each of the B·P sequences (one a pixel of each of B scenes) holds n tokens
(the learned token and the L views), and each of its h heads computes
softmax(q kᵀ / √d + key bias) · v, where the key bias is 0 for a key that
counts and −∞ for a masked one (a padded view) and is the scene's for every
pixel. The input is the QKV projection as it comes out of the linear layer,
(B, P, n, 3·h·d) with q, k and v side by side and each split into h heads of
d; the output is (B, P, n, h·d), the heads side by side, as the output
projection takes it.

- ``attend_ref``: the plain version, written-out matrix products and a
  softmax (the CPU path, the test oracle, and the backward's recompute);
- ``attend_cuda``: K5, the hand-written kernel (``csrc/attend.cu``, whose
  notes give its design). No TPU kernel stands behind it; it replaces the
  plain version's head-split copies, its two batched GEMMs of 17 x 64 x 17,
  its softmax and its head-merge copy: 36 ms a block at a batch of 8
  Proba-V scenes, where the 18.25 GB that the work must move take 5.45 ms
  at 3.35 TB/s and K5 takes 8.0 (PERF.md §6). One warp takes one
  (sequence, head), a lane one query row, in float32 FMA (no tensor cores,
  so no TF32); every lane owns its outputs, so the result is deterministic.
  Head widths 8, 16, 32 and 64, at most 32 tokens;
- ``Attend``: the autograd Function, the kernel forward and a backward that
  recomputes the plain version and takes its gradient (deterministic: batched
  GEMMs, softmax and copies, no atomics);
- ``attend``: dispatch by the device: CPU -> plain version, CUDA -> ``Attend``
  (the kernel, or raise). There is no fallback from CUDA to the plain version.

``LAUNCHES`` counts the kernel's launches, so a run can show that its
forward went through it.
"""

from __future__ import annotations

import torch

from highresnet_tpu_torch.kernels.alloc import empty_output

LAUNCHES = 0
HEAD_DIMS = (8, 16, 32, 64)  # the kernel's instances
MAX_TOKENS = 32  # a lane per query row


def attend_ref(qkv: torch.Tensor, key_bias: torch.Tensor, heads: int) -> torch.Tensor:
    """``qkv`` (B, P, n, 3·h·d), ``key_bias`` (B, n) -> (B, P, n, h·d) (the
    module notes), in plain PyTorch."""
    q, k, v = qkv.unflatten(-1, (3, heads, -1)).unbind(-3)  # (B, P, n, h, d)
    q, k, v = (t.transpose(-2, -3) for t in (q, k, v))  # (B, P, h, n, d)
    scores = torch.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    weights = torch.softmax(scores + key_bias[:, None, None, None, :], dim=-1)
    return torch.matmul(weights, v).transpose(-2, -3).flatten(-2)


def attend_cuda(qkv: torch.Tensor, key_bias: torch.Tensor, heads: int) -> torch.Tensor:
    """K5 on the current stream (the module notes)."""
    global LAUNCHES
    if qkv.device.type != "cuda" or key_bias.device != qkv.device:
        raise ValueError(f"attend_cuda needs CUDA tensors, got {qkv.device} and {key_bias.device}")
    if qkv.dtype != torch.float32 or key_bias.dtype != torch.float32:
        raise TypeError(f"attend_cuda computes in float32, got {qkv.dtype} and {key_bias.dtype}")
    b, p, n, width = qkv.shape
    if width % (3 * heads) or key_bias.shape != (b, n):
        raise ValueError(f"attend_cuda: qkv {tuple(qkv.shape)} and key bias "
                         f"{tuple(key_bias.shape)} do not fit {heads} heads")
    d = width // (3 * heads)
    if d not in HEAD_DIMS or n > MAX_TOKENS:
        raise ValueError(f"attend_cuda takes head widths {HEAD_DIMS} and at most "
                         f"{MAX_TOKENS} tokens, got {d} and {n}")
    qkv, key_bias = qkv.contiguous(), key_bias.contiguous()
    if qkv.data_ptr() % 16:
        raise ValueError("attend_cuda reads qkv in 16-byte pieces: its data must be 16-byte aligned")
    out = empty_output((b, p, n, heads * d), qkv.dtype, qkv.device)
    if out.numel() == 0:
        return out
    from highresnet_tpu_torch.kernels import build

    lib = build.load()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = lib.hrn_attend(qkv.data_ptr(), key_bias.data_ptr(), out.data_ptr(), b * p, p, n,
                            heads, d, d ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"hrn_attend launch failed: cudaError_t {rc}")
    LAUNCHES += 1
    return out


class Attend(torch.autograd.Function):
    """Forward: the kernel. Backward: the plain version's gradient at the
    same input, recomputed (the module notes)."""

    @staticmethod
    def forward(ctx, qkv, key_bias, heads):
        ctx.save_for_backward(qkv, key_bias)
        ctx.heads = heads
        return attend_cuda(qkv, key_bias, heads)

    @staticmethod
    def backward(ctx, grad):
        qkv, key_bias = ctx.saved_tensors
        with torch.enable_grad():
            x = qkv.detach().requires_grad_()
            (g,) = torch.autograd.grad(attend_ref(x, key_bias, ctx.heads), x, grad)
        return g, None, None


def attend(qkv: torch.Tensor, key_bias: torch.Tensor, heads: int) -> torch.Tensor:
    """Dispatch by device: the plain version on the CPU, the kernel on CUDA."""
    if qkv.device.type == "cpu":
        return attend_ref(qkv, key_bias, heads)
    return Attend.apply(qkv, key_bias, heads)
