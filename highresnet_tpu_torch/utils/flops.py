"""Analytic FLOP counts of the model's forwards and steps, and utilization.

The counterpart of ``highresnet_tpu/utils/flops.py``: the same counts of
multiply-add FLOPs (2 x MACs) of the conv and matmul path for a network
config and input geometry, and ``utilization`` against one NVIDIA H100
SXM's published dense peaks (NVIDIA's data sheet, at the full 700 W power
limit): 67 TFLOP/s in float32 outside the tensor cores (TF32 stays off in
the port) and 989 TFLOP/s in bfloat16 on the tensor cores.
"""

from __future__ import annotations

from typing import Any, Dict

H100_PEAK_TFLOPS = {"float32": 67.0, "bfloat16": 989.0}


def conv_flops(h: int, w: int, cin: int, cout: int, k: int = 3) -> float:
    return 2.0 * h * w * cin * cout * k * k


def hrnet_forward_flops(config: Dict[str, Any], batch: int, views: int, size: int) -> float:
    """Total forward FLOPs for (batch, views, size, size) inputs."""
    enc = config.get("encoder", {})
    rec = config.get("recursive", {})
    dec = config.get("decoder", {})
    c = enc.get("channel_size", 64)
    k = enc.get("kernel_size", 3)
    n_res = enc.get("num_layers", 2)
    cin = enc.get("in_channels", 2)

    per_image = conv_flops(size, size, cin, c, k)  # init conv
    per_image += n_res * 2 * conv_flops(size, size, c, c, k)  # res blocks
    per_image += conv_flops(size, size, c, c, k)  # final conv
    total = batch * views * per_image

    # fusion tree: sum over halving rounds of (B * half) fuse blocks
    cf = rec.get("in_channels", c)
    kf = rec.get("kernel_size", 3)
    nviews = views
    while nviews // 2 > 0:
        half = nviews // 2
        fuse_per = 2 * conv_flops(size, size, 2 * cf, 2 * cf, kf) + conv_flops(
            size, size, 2 * cf, cf, kf
        )
        total += batch * half * fuse_per
        nviews = half

    # decoder: per-pixel matmul C -> 9*C (== deconv k3 s3) + 1x1 conv at 3x res
    dd = dec.get("deconv", {})
    df = dec.get("final", {})
    s = dd.get("stride", 3)
    cd = dd.get("out_channels", c)
    total += batch * 2.0 * size * size * cf * cd * s * s
    total += batch * conv_flops(s * size, s * size, cd, df.get("out_channels", 1),
                                df.get("kernel_size", 1))
    return total


def shiftnet_forward_flops(batch: int, size: int = 128) -> float:
    """ShiftNet conv stack + fc FLOPs per forward (one pair per scene).

    Architecture per the reference (src/DeepNetworks/ShiftNet.py:6-90):
    8 conv3x3 layers widths [64,64,64,64,128,128,128,128], 2x maxpool
    after layers 2/4/6, fc 32768->1024->2.
    """
    widths = [64, 64, 64, 64, 128, 128, 128, 128]
    pools = [False, True, False, True, False, True, False, False]
    cin, s = 2, size
    total = 0.0
    for ch, pool in zip(widths, pools):
        total += conv_flops(s, s, cin, ch)
        cin = ch
        if pool:
            s //= 2
    total += 2.0 * (cin * s * s) * 1024 + 2.0 * 1024 * 2  # fc1 + fc2
    return batch * total


def lanczos_warp_flops(batch: int, size: int, n: int = 7) -> float:
    """Separable n-tap warp: two 1-D FMA passes over (size, size)."""
    return batch * 2.0 * (2.0 * n * size * size)


def train_step_flops(
    config: Dict[str, Any],
    batch: int,
    views: int,
    patch: int,
    register_size: int = 128,
) -> float:
    """Full registered train step.

    forward + backward ~ 3x forward for the conv stacks (grads w.r.t.
    inputs and weights each cost ~1 forward); the optimizer update and
    loss reductions are O(params + pixels) — negligible next to TFLOPs.
    """
    fwd = (
        hrnet_forward_flops(config, batch, views, patch)
        + shiftnet_forward_flops(batch, register_size)
        + lanczos_warp_flops(batch, 3 * patch)
    )
    return 3.0 * fwd


def eval_step_flops(config: Dict[str, Any], batch: int, views: int, size: int) -> float:
    """Validation step: SR forward + on-device 7x7 integer shift search.

    The search evaluates 49 bias-corrected masked MSEs over the trimmed
    (3*size - 2*border)^2 window (ops/metrics.py::shift_cpsnr); each
    placement costs ~7 elementwise ops/pixel (diff, mask product, bias
    reduction, centered square, masked sum). Elementwise work, counted so
    an achieved TFLOP/s is an honest total, with the forward dominating.
    """
    hr_trim = 3 * size - 2 * 3
    search = batch * 49.0 * 7.0 * hr_trim * hr_trim
    return hrnet_forward_flops(config, batch, views, size) + search


def utilization(flops: float, seconds: float, dtype: str = "float32") -> Dict[str, float]:
    """Achieved TFLOP/s for ``flops`` in ``seconds`` and its share of the
    H100 peak of ``dtype``; a reading above the peak is marked
    ``timing_suspect`` (the time is too short to be true)."""
    peak = H100_PEAK_TFLOPS.get(dtype, H100_PEAK_TFLOPS["float32"])
    if seconds <= 0:
        return {"achieved_tflops_per_s": None, "utilization": None,
                "peak_basis_tflops_per_s": peak}
    tflops = flops / seconds / 1e12
    out = {
        "achieved_tflops_per_s": round(tflops, 2),
        "utilization": round(tflops / peak, 3),
        "peak_basis_tflops_per_s": peak,
    }
    if tflops > peak:
        out["timing_suspect"] = True
    return out
