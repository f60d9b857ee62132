"""Seeded weights on the device, in a few large calls.

Each parameter follows its initial law in the reference's ``param_spec``:
``kernel`` a normal truncated at two standard deviations with variance
1 / fan_in (flax's ``lecun_normal``, the law the models are trained
from), ``zero``, ``one``, or ``prelu`` (0.25). All kernels come from one
truncated-normal draw, sliced and scaled.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from perfbench.reference.hrnet import Spec

TRUNC_STD = 0.87962566103423978  # the std of a unit normal truncated at +-2
CONSTANT = {"zero": 0.0, "one": 1.0, "prelu": 0.25}


def make(spec: Spec, g: torch.Generator, device, prefix: str = "") -> Dict[str, torch.Tensor]:
    draw = torch.empty(sum(math.prod(s) for _, s, law, _ in spec if law == "kernel"),
                       device=device)
    torch.nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=g)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for key, shape, law, fan in spec:
        if law == "kernel":
            n = math.prod(shape)
            out[prefix + key] = (draw[at:at + n] * (math.sqrt(1.0 / fan) / TRUNC_STD)).reshape(shape)
            at += n
        else:
            out[prefix + key] = torch.full(shape, CONSTANT[law], device=device)
    return out
