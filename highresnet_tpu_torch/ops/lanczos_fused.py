"""The fused Lanczos warp: K3 as a CUDA kernel, with the plain version's VJP.

The counterpart of ``highresnet_tpu/ops/lanczos_pallas.py``:

- ``lanczos_shift_ref``: the plain version (``ops.lanczos.lanczos_shift``
  at ``int_range=0``, Lanczos-3, 7 taps); CPU path and test oracle.
- ``lanczos_shift_cuda(img, shift)``: the kernel (``csrc/lanczos_shift.cu``),
  one launch that computes each image's taps from its (dy, dx) as
  ``lanczos_kernel`` does and resamples the image; float32 only, H and W at
  least 4. ``img`` is a contiguous batch, or one (H, W) image expanded over
  the batch (``img.expand(B, H, W)``, stride 0), which the kernel reads in
  place: warping one image many ways moves one image in, not B. The JAX
  wrapper computes the taps just outside its kernel; here they are inside.
- ``LanczosShift``: autograd Function. Its forward runs K3 (shift cast to
  the image dtype); its backward is the plain version's VJP at the saved
  (img, shift), as the JAX package's ``_pallas_bwd`` reuses the XLA VJP.
- ``lanczos_shift_fused``: dispatch by the tensor's device: CPU -> plain
  version, CUDA -> ``LanczosShift`` (the kernel, or raise).
- ``training_warp``: the one choice of warp that the train step and the
  ShiftNet warm-start share.

``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from highresnet_tpu_torch.kernels.alloc import empty_output
from highresnet_tpu_torch.ops.lanczos import lanczos_shift

LAUNCHES = 0
TAPS = 7
MAX_WIDTH = 1531  # one row plus its halos in the 48 KiB of shared memory a block may use


def lanczos_shift_ref(img: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    return lanczos_shift(img, shift, a=3, n=TAPS)


def _broadcast(img: torch.Tensor) -> bool:
    """One (H, W) image expanded over the batch: stride 0 on B, rows contiguous."""
    return img.dim() == 3 and img.stride(0) == 0 and img[0].is_contiguous()


def lanczos_shift_cuda(img: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Launch K3 on the current stream: img (B, H, W), contiguous or one
    image expanded over B, shift (B, 2) -> (B, H, W)."""
    global LAUNCHES
    if img.dim() != 3:
        raise ValueError(f"lanczos_shift_cuda expects (B, H, W), got {tuple(img.shape)}")
    b, h, w = img.shape
    if shift.shape != (b, 2):
        raise ValueError(f"shift must be ({b}, 2), got {tuple(shift.shape)}")
    for name, t in (("img", img), ("shift", shift)):
        if t.device.type != "cuda":
            raise ValueError(f"lanczos_shift_cuda needs CUDA tensors, got {name} on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"lanczos_shift_cuda takes float32 only, got {name} {t.dtype}")
        if not (t.is_contiguous() or (t is img and _broadcast(img))):
            raise ValueError(f"lanczos_shift_cuda expects a contiguous {name}")
    if shift.device != img.device:
        raise ValueError(f"img on {img.device} and shift on {shift.device}")
    if h < 4 or w < 4:
        raise ValueError(f"a reflect pad of 3 needs H, W >= 4, got {h}x{w}")
    if w > MAX_WIDTH or b > 65535:
        raise ValueError(f"lanczos_shift_cuda takes W <= {MAX_WIDTH} and B <= 65535, got {b}x{w}")
    out = empty_output(img.shape, img.dtype, img.device)  # the kernel writes every element
    img_stride = 0 if _broadcast(img) else h * w

    from highresnet_tpu_torch.kernels import build

    lib = build.load()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        rc = lib.hrn_lanczos_shift(img.data_ptr(), shift.data_ptr(), out.data_ptr(), b, h, w,
                                   img_stride, stream)
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
        img_in = img if _broadcast(img) else img.contiguous()
        return lanczos_shift_cuda(img_in, shift.to(img.dtype).contiguous())

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


def training_warp(img: torch.Tensor, shift: torch.Tensor, int_range: int = 0,
                  fused: bool = False) -> torch.Tensor:
    """The warp of the train step and the ShiftNet warm-start: ``int_range > 0``
    takes the plain extended-range warp (no kernel, as in the JAX package);
    otherwise ``fused`` (``training.use_pallas_warp``) takes the fused warp
    and the plain warp is used without it."""
    if int_range:
        return lanczos_shift(img, shift, int_range=int_range)
    if fused:
        return lanczos_shift_fused(img, shift)
    return lanczos_shift(img, shift)
