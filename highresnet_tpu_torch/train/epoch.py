"""One training epoch + the warp-window guard.

The counterpart of ``highresnet_tpu/train/epoch.py``. Metrics accumulate on
the device (sums for loss / mean shift / grad norm, a max for
``max_abs_shift``) and the epoch reads them back to the host once, at its
end. In a multi-process run the step's metrics are already global and the
epoch counts the scenes of every replica, so each rank ends with the same
stats.
"""

from __future__ import annotations

import time
import warnings
from typing import Any, Callable, Dict, Optional

import torch

from highresnet_tpu_torch.utils.profiling import span


def warp_window_px(t: Dict[str, Any]) -> float:
    """Accurate range of the loss-time Lanczos warp: ±3 px for the single
    7-tap pass, ±(K + 0.5) px with training.warp_int_range = K."""
    k = int(t.get("warp_int_range", 0) or 0)
    return 3.0 if k <= 0 else k + 0.5


def warn_warp_window(
    t: Dict[str, Any], max_abs_shift: float, epoch: int, warn_from: int = 1
) -> int:
    """Warn when a predicted shift leaves the warp window.

    Re-arms on a doubling epoch back-off: a warning at epoch e arms the next
    at 2e, so a persistent violation keeps showing (epochs 1, 2, 4, 8, ...)
    while a one-epoch transient warns once. Returns the updated threshold
    (pass it back next epoch)."""
    if not t.get("register", True) or epoch < warn_from:
        return warn_from
    window = warp_window_px(t)
    if max_abs_shift > window:
        warnings.warn(
            f"epoch {epoch}: predicted registration shift "
            f"{max_abs_shift:.2f} px exceeds the warp's accurate window "
            f"(±{window:.1f} px) — the registered loss is degrading "
            "alignments it cannot express. Raise training.warp_int_range "
            "or reduce the misalignment scale."
        )
        return max(2 * epoch, epoch + 1)
    return warn_from


def batch_to_device(batch, device: torch.device):
    """(lrs, alphas, hrs, hr_maps) of a collated numpy batch as device tensors."""
    arrays = (batch.lrs, batch.alphas, batch.hrs, batch.hr_maps)
    return tuple(torch.from_numpy(a).to(device, non_blocking=True) for a in arrays)


def run_train_epoch(
    loader,
    state,
    step_fn: Callable,
    device: torch.device,
    steps_left: Optional[int] = None,
    replicas: int = 1,
):
    """Run train steps over one pass of ``loader`` (at most ``steps_left``),
    whose batches are one of ``replicas`` equal shards of each global batch.

    Returns (state, stats, n_steps); stats has train_loss (weighted per
    scene), mean_abs_shift, grad_norm, max_abs_shift and seconds.
    """
    sums = None  # device (loss*n, mean_abs_shift, grad_norm); max_abs_shift apart
    peak = None
    n_seen = 0
    n_steps = 0
    t0 = time.time()
    with span("train.epoch"):
        for batch in loader:
            with span("train.feed"):
                arrays = batch_to_device(batch, device)
            with span("train.step"):
                state, m = step_fn(state, *arrays)
            n = len(batch.names) * replicas  # equal shards (drop_last)
            contrib = torch.stack([m["loss"] * n, m["mean_abs_shift"], m["grad_norm"]])
            sums = contrib if sums is None else sums + contrib
            peak = m["max_abs_shift"] if peak is None else torch.maximum(peak, m["max_abs_shift"])
            n_seen += n
            n_steps += 1
            if steps_left is not None and n_steps >= steps_left:
                break
        if n_seen:
            with span("train.readback"):
                host = torch.cat([sums, peak[None]]).tolist()  # one host sync per epoch
            stats = {
                "train_loss": host[0] / n_seen,
                "mean_abs_shift": host[1] / n_steps,
                "grad_norm": host[2] / n_steps,
                "max_abs_shift": host[3],
            }
        else:
            stats = {k: 0.0 for k in ("train_loss", "mean_abs_shift", "grad_norm",
                                      "max_abs_shift")}
    stats["seconds"] = time.time() - t0
    return state, stats, n_steps
