"""The SR network a configuration names, and what it brings to the port's
paths: how it is built, its weights file, and whether it comes with
ShiftNet. The one module besides ``config.py`` that reads ``network.arch``;
serving, training and the checkpoints ask here.

HRNet comes with ShiftNet: it trains registered by it, its run keeps
``ShiftNet.pth`` beside its weights, and it serves TTA, ensembles and
ShiftNet-registered scoring besides the plain forward. RAMS does not: it
trains unregistered (its loss, cL1, searches the registration itself) and
serves the plain forward only.
"""

from __future__ import annotations

from typing import Any, Mapping, Tuple

import torch
from torch import nn

from highresnet_tpu_torch.config import network_arch
from highresnet_tpu_torch.models import rams
from highresnet_tpu_torch.models.convert import SHIFTNET_NAME, WEIGHTS_NAME
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
    return rams.WEIGHTS_NAME if network_arch(config) == "rams" else WEIGHTS_NAME


def with_shiftnet(config: Mapping[str, Any]) -> bool:
    """Whether the network comes with ShiftNet (the module notes)."""
    return network_arch(config) == "hrnet"


def best_files(config: Mapping[str, Any]) -> Tuple[str, ...]:
    """The files a run's ``best/`` holds: the network's weights, then
    ``ShiftNet.pth`` where the network comes with ShiftNet."""
    if with_shiftnet(config):
        return weights_file(config), SHIFTNET_NAME
    return (weights_file(config),)
