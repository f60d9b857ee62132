"""Device setup and compute dtypes.

``setup_device`` fixes the numerics the JAX reference is held to before any
work reaches the card:

- TF32 off for both cuDNN convolutions and cuBLAS matmuls: cuDNN's default
  runs f32 convolutions as TF32 (~3 decimal digits), which breaks the f32
  parity contract;
- deterministic algorithms on, ``cudnn.benchmark`` off, and
  ``CUBLAS_WORKSPACE_CONFIG`` set before the first cuBLAS call (without it
  deterministic mode makes cuBLAS calls raise).

These are process-wide settings, so only entry points (the CLI, scripts)
call ``setup_device``, and only a CUDA device changes them. Library code
calls ``resolve_device``, which validates and changes nothing, or
``as_tensor``, which puts host arrays on a device so resolved. A CUDA device
that is missing raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import os
import subprocess

import numpy as np
import torch

CUBLAS_WORKSPACE = ":4096:8"


def setup_device(device: str | torch.device) -> torch.device:
    """Resolve ``device`` and, for CUDA, fix the process's numerics."""
    device = resolve_device(device)
    if device.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True)
    return device


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def resolve_device(device: str | torch.device) -> torch.device:
    """``cuda`` -> ``cuda:0``; raises for a CUDA device that is not there."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
        index = 0 if device.index is None else device.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {device} requested but only {torch.cuda.device_count()} "
                "CUDA device(s) are visible"
            )
        device = torch.device("cuda", index)
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}; use cuda or cpu")
    return device


def as_tensor(x, device="cuda") -> torch.Tensor:
    """float32 tensor of ``x``: a tensor stays on its own device; anything
    else (numpy, lists) is copied to ``device`` (``resolve_device``: a CUDA
    device that is missing raises)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.tensor(np.asarray(x, np.float32), device=resolve_device(device))


def compute_dtypes(compute_dtype: str | None) -> tuple[torch.dtype, torch.dtype]:
    """Map ``training.compute_dtype`` to HRNet's (body, decoder) dtypes.

    The counterpart of ``highresnet_tpu.models.hrnet.resolve_compute_dtypes``:
    "float32"/None -> (f32, f32); "bfloat16" -> (bf16, bf16);
    "mixed" -> (bf16 body, f32 decoder).
    """
    if compute_dtype in (None, "float32"):
        return torch.float32, torch.float32
    if compute_dtype == "bfloat16":
        return torch.bfloat16, torch.bfloat16
    if compute_dtype == "mixed":
        return torch.bfloat16, torch.float32
    raise ValueError(
        f"compute_dtype must be float32 | bfloat16 | mixed, got {compute_dtype!r}"
    )
