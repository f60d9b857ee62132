"""The SR network a configuration names, and what it brings to the port's
paths: how it is built, its weights file, and whether it comes with
ShiftNet. The one module besides ``config.py`` that reads ``network.arch``;
serving, training and the checkpoints ask here.

HRNet and TR-MISR come with ShiftNet: they train registered by it, their
runs keep ``ShiftNet.pth`` beside their weights, and they serve TTA,
ensembles and ShiftNet-registered scoring besides the plain forward. RAMS
does not: it trains unregistered (its loss, cL1, searches the registration
itself) and serves the plain forward only.

Every SR network's forward is ``forward(lrs, alphas, generator=None)``; the
train step passes its dropout generator, and a network without dropout in
its train forward (HRNet, RAMS) leaves it unused. TR-MISR draws its masks
from it at the rate in its ``dropout`` attribute.
"""

from __future__ import annotations

from typing import Any, Mapping, Tuple

import torch
from torch import nn

from highresnet_tpu_torch.config import network_arch
from highresnet_tpu_torch.models import rams, trmisr
from highresnet_tpu_torch.models.convert import SHIFTNET_NAME, WEIGHTS_NAME
from highresnet_tpu_torch.models.hrnet import HRNet
from highresnet_tpu_torch.runtime import compute_dtypes


NAMES = {"hrnet": "HRNet", "rams": "RAMS", "trmisr": "TR-MISR"}


def build_network(config: Mapping[str, Any], device,
                  generator: torch.Generator | None = None) -> nn.Module:
    """``config``'s SR network on ``device``, drawn from ``generator``: HRNet
    at ``training.compute_dtype``, or RAMS or TR-MISR, which compute in float32."""
    compute_dtype = config["training"].get("compute_dtype")
    arch = network_arch(config)
    if arch != "hrnet":
        if compute_dtype not in (None, "float32"):
            raise ValueError(f"{NAMES[arch]} computes in float32; training.compute_dtype "
                             f"is {compute_dtype!r}")
        model = rams.RAMS if arch == "rams" else trmisr.TRNet
        return model(config["network"], device=device, generator=generator)
    dtype, decoder_dtype = compute_dtypes(compute_dtype)
    return HRNet(config["network"], device=device, dtype=dtype, decoder_dtype=decoder_dtype,
                 generator=generator)


def weights_file(config: Mapping[str, Any]) -> str:
    """The file that holds the network's weights: ``HRNet.pth``, ``RAMS.pth``
    or ``TRNet.pth``."""
    return {"hrnet": WEIGHTS_NAME, "rams": rams.WEIGHTS_NAME,
            "trmisr": trmisr.WEIGHTS_NAME}[network_arch(config)]


def with_shiftnet(config: Mapping[str, Any]) -> bool:
    """Whether the network comes with ShiftNet (the module notes)."""
    return network_arch(config) != "rams"


def best_files(config: Mapping[str, Any]) -> Tuple[str, ...]:
    """The files a run's ``best/`` holds: the network's weights, then
    ``ShiftNet.pth`` where the network comes with ShiftNet."""
    if with_shiftnet(config):
        return weights_file(config), SHIFTNET_NAME
    return (weights_file(config),)
