"""The fused Lanczos warp: K3 as a CUDA kernel, with the plain version's VJP.

The counterpart of ``highresnet_tpu/ops/lanczos_pallas.py``:

- ``lanczos_shift_ref``: the plain version (``ops.lanczos.lanczos_shift``
  at ``int_range=0``, Lanczos-3, 7 taps); CPU path and test oracle.
- ``lanczos_shift_cuda(img, ky, kx)``: the kernel (``csrc/lanczos_shift.cu``)
  on given taps, float32 only, H and W at least 4.
- ``LanczosShift``: autograd Function. Its forward computes the taps with
  ``lanczos_kernel`` (shift cast to the image dtype) and runs K3; its
  backward is the plain version's VJP at the saved (img, shift), as the JAX
  package's ``_pallas_bwd`` reuses the XLA VJP.
- ``lanczos_shift_fused``: dispatch by the tensor's device: CPU -> plain
  version, CUDA -> ``LanczosShift`` (the kernel, or raise).

``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from highresnet_tpu_torch.ops.lanczos import lanczos_kernel, lanczos_shift

LAUNCHES = 0
TAPS = 7
MAX_WIDTH = 1535  # one row plus its halo in the 48 KiB of shared memory a block may use


def lanczos_shift_ref(img: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    return lanczos_shift(img, shift, a=3, n=TAPS)


def lanczos_shift_cuda(img: torch.Tensor, ky: torch.Tensor, kx: torch.Tensor) -> torch.Tensor:
    """Launch K3 on the current stream: img (B, H, W), taps (B, 7) -> (B, H, W)."""
    global LAUNCHES
    for name, t in (("img", img), ("ky", ky), ("kx", kx)):
        if t.device.type != "cuda":
            raise ValueError(f"lanczos_shift_cuda needs CUDA tensors, got {name} on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"lanczos_shift_cuda takes float32 only, got {name} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"lanczos_shift_cuda expects a contiguous {name}")
    if img.dim() != 3:
        raise ValueError(f"lanczos_shift_cuda expects (B, H, W), got {tuple(img.shape)}")
    b, h, w = img.shape
    if ky.shape != (b, TAPS) or kx.shape != (b, TAPS):
        raise ValueError(f"taps must be ({b}, {TAPS}), got {tuple(ky.shape)}, {tuple(kx.shape)}")
    if h < 4 or w < 4:
        raise ValueError(f"a reflect pad of 3 needs H, W >= 4, got {h}x{w}")
    if w > MAX_WIDTH or b > 65535:
        raise ValueError(f"lanczos_shift_cuda takes W <= {MAX_WIDTH} and B <= 65535, got {b}x{w}")
    out = torch.empty_like(img)

    from highresnet_tpu_torch.kernels import build

    lib = build.load()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        rc = lib.hrn_lanczos_shift(img.data_ptr(), ky.data_ptr(), kx.data_ptr(),
                                   out.data_ptr(), b, h, w, stream)
    if rc != 0:
        raise RuntimeError(f"hrn_lanczos_shift launch failed: cudaError_t {rc}")
    LAUNCHES += 1
    return out


class LanczosShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(img, shift)
        if img.device.type == "cpu":
            return lanczos_shift_ref(img, shift)
        ky = lanczos_kernel(shift[:, 0].to(img.dtype), a=3, n=TAPS)
        kx = lanczos_kernel(shift[:, 1].to(img.dtype), a=3, n=TAPS)
        return lanczos_shift_cuda(img.contiguous(), ky.contiguous(), kx.contiguous())

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        img, shift = ctx.saved_tensors
        with torch.enable_grad():
            img = img.detach().requires_grad_()
            shift = shift.detach().requires_grad_()
            out = lanczos_shift_ref(img, shift)
            return torch.autograd.grad(out, (img, shift), g)


def lanczos_shift_fused(img: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    if img.device.type == "cpu":
        return lanczos_shift_ref(img, shift)
    return LanczosShift.apply(img, shift)
