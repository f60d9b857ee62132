"""The SR network a configuration names, and its weights file.

``network.arch`` (``config.network_arch``) picks HRNet (the default) or
RAMS; serving (``eval/evaluator.py``), training (``train/state.py``) and the
checkpoints (``train/checkpoint.py``) build and name the network here.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from highresnet_tpu_torch.config import network_arch
from highresnet_tpu_torch.models import rams
from highresnet_tpu_torch.models.convert import WEIGHTS_NAME as HRNET_WEIGHTS
from highresnet_tpu_torch.models.hrnet import HRNet
from highresnet_tpu_torch.runtime import compute_dtypes


def build_network(config: Mapping[str, Any], device,
                  generator: torch.Generator | None = None) -> nn.Module:
    """``config``'s SR network on ``device``, drawn from ``generator``: HRNet
    at ``training.compute_dtype``, or RAMS, which computes in float32."""
    compute_dtype = config["training"].get("compute_dtype")
    if network_arch(config) == "rams":
        if compute_dtype not in (None, "float32"):
            raise ValueError(
                f"RAMS computes in float32; training.compute_dtype is {compute_dtype!r}")
        return rams.RAMS(config["network"], device=device, generator=generator)
    dtype, decoder_dtype = compute_dtypes(compute_dtype)
    return HRNet(config["network"], device=device, dtype=dtype, decoder_dtype=decoder_dtype,
                 generator=generator)


def weights_file(config: Mapping[str, Any]) -> str:
    """The file that holds the network's weights: ``HRNet.pth`` or ``RAMS.pth``."""
    return rams.WEIGHTS_NAME if network_arch(config) == "rams" else HRNET_WEIGHTS
