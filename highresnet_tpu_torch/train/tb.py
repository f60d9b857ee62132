"""Gated TensorBoard writing.

A copy of ``highresnet_tpu/train/tb.py``, which cannot be imported without
flax and optax (``highresnet_tpu.train``'s package imports them). The
reference logs scalars plus the first val SR image (min-max normalised) and
the raw HR-SR error map each epoch (src/train.py:219-228). tensorboardX is
optional: absent, the writer is inert.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


class TBWriter:
    """SummaryWriter wrapper that no-ops when TB is unavailable/disabled."""

    def __init__(self, tb_dir: Optional[str], run_name: str, enabled: bool = True):
        self._writer = None
        if enabled and tb_dir:
            try:
                from tensorboardX import SummaryWriter

                self._writer = SummaryWriter(os.path.join(tb_dir, run_name))
            except ImportError:
                pass

    @property
    def active(self) -> bool:
        return self._writer is not None

    def log_epoch(
        self,
        epoch: int,
        scalars: Dict[str, Optional[float]],
        sr0: Optional[np.ndarray] = None,
        hr0: Optional[np.ndarray] = None,
    ) -> None:
        """Write scalars (None values skipped) and the per-epoch images."""
        if self._writer is None:
            return
        for key, value in scalars.items():
            if value is not None:
                self._writer.add_scalar(key, value, epoch)
        if sr0 is not None:
            # reference logs the first val SR min-max normalized and the
            # raw HR-SR error map each epoch (src/train.py:226-228)
            sr0 = np.asarray(sr0, np.float32)
            lo, hi = float(sr0.min()), float(sr0.max())
            norm = (sr0 - lo) / max(hi - lo, 1e-12)
            self._writer.add_image("SR Image", norm, epoch, dataformats="HW")
            self._writer.add_image(
                "Error Map", np.asarray(hr0, np.float32) - sr0, epoch, dataformats="HW"
            )

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
