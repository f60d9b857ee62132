"""Weights: flax param trees -> reference state dicts, and HRNet.pth IO.

The inverses of ``highresnet_tpu.models.convert.hrnet_params_from_torch``
and ``shiftnet_from_torch``, written without JAX: the trees' leaves only
need to be array-like (numpy arrays, or anything ``np.asarray`` takes).
Kernels go HWIO -> OIHW; the decoder's deconv kernel (kh, kw, in, out) ->
ConvTranspose2d's (in, out, kh, kw); dense kernels (in, out) -> (out, in).

The port's weights file is the reference's own ``HRNet.pth`` state-dict
format. A JAX run directory's Orbax ``best/`` is turned into one with
``scripts/export_torch_weights.py``, outside the port (Orbax needs JAX).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

WEIGHTS_NAME = "HRNet.pth"


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(out: Dict[str, torch.Tensor], key: str, p: Mapping[str, Any]) -> None:
    out[f"{key}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    out[f"{key}.bias"] = _t(p["bias"])


def _prelu(out: Dict[str, torch.Tensor], key: str, p: Mapping[str, Any]) -> None:
    out[f"{key}.weight"] = _t(np.asarray(p["alpha"]).reshape(1))


def _resblock(out: Dict[str, torch.Tensor], prefix: str, p: Mapping[str, Any]) -> None:
    _conv(out, f"{prefix}.block.0", p["conv0"])
    _prelu(out, f"{prefix}.block.1", p["prelu0"])
    _conv(out, f"{prefix}.block.2", p["conv1"])
    _prelu(out, f"{prefix}.block.3", p["prelu1"])


def hrnet_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax HRNet params {'encode', 'fuse', 'decode'} -> reference state dict."""
    enc, fuse, dec = params["encode"], params["fuse"], params["decode"]
    out: Dict[str, torch.Tensor] = {}
    _conv(out, "encode.init_layer.0", enc["init_conv"])
    _prelu(out, "encode.init_layer.1", enc["init_prelu"])
    n_res = sum(1 for k in enc if k.startswith("res"))
    for i in range(n_res):
        _resblock(out, f"encode.res_layers.{i}", enc[f"res{i}"])
    _conv(out, "encode.final.0", enc["final_conv"])
    _resblock(out, "fuse.fuse.0", fuse["fuse_res"])
    _conv(out, "fuse.fuse.1", fuse["fuse_conv"])
    _prelu(out, "fuse.fuse.2", fuse["fuse_prelu"])
    out["decode.deconv.0.weight"] = _t(np.asarray(dec["deconv_kernel"]).transpose(2, 3, 0, 1))
    out["decode.deconv.0.bias"] = _t(dec["deconv_bias"])
    _prelu(out, "decode.deconv.1", dec["deconv_prelu"])
    _conv(out, "decode.final", dec["final_conv"])
    return out


def shiftnet_state_dict_from_flax(
    params: Mapping[str, Any], batch_stats: Mapping[str, Any]
) -> Dict[str, torch.Tensor]:
    """Flax ShiftNet params + batch_stats -> reference ShiftNet.pth state dict
    (the inverse of ``highresnet_tpu.models.convert.shiftnet_from_torch``)."""
    out: Dict[str, torch.Tensor] = {}
    for i in range(1, 9):
        _conv(out, f"layer{i}.0", params[f"conv{i}"])
        bn, stats = params[f"bn{i}"], batch_stats[f"bn{i}"]
        out[f"layer{i}.1.weight"] = _t(bn["scale"])
        out[f"layer{i}.1.bias"] = _t(bn["bias"])
        out[f"layer{i}.1.running_mean"] = _t(stats["mean"])
        out[f"layer{i}.1.running_var"] = _t(stats["var"])
        out[f"layer{i}.1.num_batches_tracked"] = torch.tensor(0)
    out["fc1.weight"] = _t(np.asarray(params["fc1"]["kernel"]).T)
    out["fc1.bias"] = _t(params["fc1"]["bias"])
    out["fc2.weight"] = _t(np.asarray(params["fc2"]["kernel"]).T)
    return out


def load_weights(path_or_dir: str) -> Dict[str, torch.Tensor]:
    """Read an HRNet.pth state dict onto the CPU; tensors only, no pickled
    code. Takes the file, a directory holding it, or a run directory of the
    port's ``cli.train``, which keeps it under ``best/``."""
    path = path_or_dir
    if os.path.isdir(path_or_dir):
        candidates = [os.path.join(path_or_dir, WEIGHTS_NAME),
                      os.path.join(path_or_dir, "best", WEIGHTS_NAME)]
        path = next((p for p in candidates if os.path.isfile(p)), None)
        if path is None:
            raise FileNotFoundError(
                f"{path_or_dir} holds no {WEIGHTS_NAME} (nor best/{WEIGHTS_NAME}); for a "
                "JAX run directory (Orbax best/) make one with scripts/export_torch_weights.py"
            )
    return torch.load(path, map_location="cpu", weights_only=True)
