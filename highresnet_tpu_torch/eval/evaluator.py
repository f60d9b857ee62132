"""Inference and benchmarking: the serving path of the port.

The counterpart of ``highresnet_tpu/eval/evaluator.py``: ``load_data``,
``get_sr_and_score``, ``load_model``, ``evaluate``, ``benchmark`` and the
``Model`` facade. The SR forward and the shift-search cPSNR both run on the
model's device.

Not ported yet, and raising ``NotImplementedError`` that names the ROADMAP
item: ShiftNet-registered scoring, checkpoint ensembles, x4/x8 TTA, and
``single_view_policy="bicubic"`` (it needs JAX's cubic resize, ROADMAP
hazard H2).

Two faults of the JAX evaluator are not carried over (ROADMAP hazard H5):
``Model.set_params`` honours ``training.compute_dtype``, and the
submission writer honours ``training.single_view_policy``.
"""

from __future__ import annotations

import os
import sys
import warnings
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import pandas as pd
import torch

from highresnet_tpu_torch.config import load_config
from highresnet_tpu_torch.data import (
    Batch,
    ImageSet,
    SceneDataset,
    collate,
    discover_scenes,
    read_baseline_cpsnr,
    train_val_split,
)
from highresnet_tpu_torch.models.convert import load_weights
from highresnet_tpu_torch.models.hrnet import HRNet
from highresnet_tpu_torch.ops.metrics import shift_cpsnr
from highresnet_tpu_torch.runtime import compute_dtypes, resolve_device

NOT_PORTED = {
    "registration": "ShiftNet-registered scoring is not ported yet (ROADMAP queue 1, item 5)",
    "ensemble": "checkpoint ensembles are not ported yet (ROADMAP queue 1, item 8)",
    "tta": "TTA is not ported yet (ROADMAP queue 1, item 8)",
    "bicubic": (
        "single_view_policy='bicubic' is not ported yet: it needs JAX's cubic "
        "resize (ROADMAP queue 3, hazard H2)"
    ),
}


def load_data(config_file_path: str, val_proportion: float = 0.10, top_k: int = -1):
    """Load train/val/test SceneDatasets + ESA baseline scores."""
    config = load_config(config_file_path)
    data_dir = config["paths"]["prefix"]

    baseline = None
    norm_path = os.path.join(data_dir, "norm.csv")
    if os.path.exists(norm_path):
        baseline = read_baseline_cpsnr(norm_path)

    train_dirs = discover_scenes(os.path.join(data_dir, "train"))
    test_dirs = discover_scenes(os.path.join(data_dir, "test"))
    train_list, val_list = train_val_split(train_dirs, val_proportion, seed=1)

    mk = lambda dirs: SceneDataset(dirs, create_patches=False, top_k=top_k)
    return mk(train_list), mk(val_list), mk(test_dirs), baseline


class _Forward:
    """numpy (lrs, alphas) in, numpy SR out; the model runs on its device."""

    def __init__(self, model: HRNet, device: torch.device):
        self.model = model.eval()
        self.device = device

    def __call__(self, lrs: np.ndarray, alphas: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            sr = self.model(
                torch.from_numpy(np.asarray(lrs, np.float32)).to(self.device),
                torch.from_numpy(np.asarray(alphas, np.float32)).to(self.device),
            )
            return sr.cpu().numpy()


def warn_out_of_range(sr: np.ndarray, name: str = "", tol: float = 0.3) -> bool:
    """Loudly flag SR output that leaves [0, 1] by more than ``tol``.

    Scoring clips to [0, 1], so such an output scores at a floor. ``tol`` is
    the JAX package's calibrated default (healthy checkpoints stay within
    0.26, degenerate ones leave by 0.39 or more). Returns True when it fired.
    """
    lo, hi = float(np.min(sr)), float(np.max(sr))
    if lo < -tol or hi > 1.0 + tol:
        warnings.warn(
            f"SR output{f' for scene {name!r}' if name else ''} leaves [0, 1] "
            f"by more than {tol} (range [{lo:.3f}, {hi:.3f}]); scores after "
            "clipping are unreliable. This typically means the checkpoint is "
            "run at a view count it was not trained with.",
            RuntimeWarning,
            stacklevel=3,
        )
        return True
    return False


def get_sr_and_score(
    imset: ImageSet | Batch,
    forward,
    min_l: int = 16,
    registration=None,
    single_view_policy: str = "warn",
) -> Tuple[np.ndarray, Optional[float]]:
    """Super-resolve one scene and (if HR exists) its shift_cPSNR.

    ``single_view_policy`` governs scenes with exactly one real view: "warn"
    runs the model and warns (fusion at L=1 measures below bicubic), "model"
    runs it silently.
    """
    if registration is not None:
        raise NotImplementedError(NOT_PORTED["registration"])
    batch = collate([imset], min_l) if isinstance(imset, ImageSet) else imset
    n_real_views = float(np.sum(np.asarray(batch.alphas[0])))
    if n_real_views <= 1.0 and single_view_policy != "model":
        if single_view_policy == "bicubic":
            raise NotImplementedError(NOT_PORTED["bicubic"])
        warnings.warn(
            "single-view scene: multi-frame fusion measures below plain "
            "bicubic at L=1 (paper Fig. 1). Set training.single_view_policy="
            "'model' to silence this.",
            RuntimeWarning,
            stacklevel=3,
        )
    sr = forward(batch.lrs, batch.alphas)[0]
    warn_out_of_range(sr, name=batch.names[0] if batch.names else "")
    score = None
    if batch.hrs is not None:
        device = getattr(forward, "device", torch.device("cpu"))
        with torch.inference_mode():
            score = float(
                shift_cpsnr(
                    torch.from_numpy(sr).to(device).clamp(0.0, 1.0),
                    torch.from_numpy(batch.hrs[0]).to(device),
                    torch.from_numpy(batch.hr_maps[0]).to(device),
                )
            )
    return sr, score


def build_model(config: Mapping[str, Any], device) -> HRNet:
    """HRNet from ``config["network"]`` at ``training.compute_dtype``."""
    dtype, decoder_dtype = compute_dtypes(config["training"].get("compute_dtype"))
    return HRNet(config["network"], device=device, dtype=dtype, decoder_dtype=decoder_dtype)


def load_model(config: Mapping[str, Any], checkpoint: str, device="cuda") -> HRNet:
    """Build HRNet and load ``HRNet.pth`` (a file, or a directory holding it).

    A CUDA device that is missing raises before the checkpoint is read."""
    device = resolve_device(device)
    model = build_model(config, device)
    model.load_state_dict(load_weights(checkpoint))
    return model.eval()


def evaluate(
    forward,
    datasets: Dict[str, SceneDataset],
    min_l: int = 16,
    registration=None,
    single_view_policy: str = "warn",
):
    """Score every scene in every split. Returns (scores, clearances, part)."""
    scores, clearances, part = {}, {}, {}
    for split, ds in datasets.items():
        for i, imset in enumerate(ds):
            _, sc = get_sr_and_score(
                imset, forward, min_l=min_l, registration=registration,
                single_view_policy=single_view_policy,
            )
            scores[imset.name] = sc
            clearances[imset.name] = imset.clearances
            part[imset.name] = split
            # heartbeat: keeps log-staleness watchdogs from killing long evals
            if i % 10 == 9:
                print(f"[evaluate] {split}: {i + 1}/{len(ds)}", file=sys.stderr, flush=True)
    return scores, clearances, part


def benchmark(baseline_cpsnrs, scores, part, clearances):
    """ESA-ratio results table, one row per scene.

    score = ESA / model per scene; < 1 beats the ESA baseline.
    """
    rows = {}
    for name, sc in scores.items():
        esa = (baseline_cpsnrs or {}).get(name)
        rows[name] = {
            "ESA": esa,
            "model": sc,
            "part": part.get(name),
            "score": (esa / sc) if (esa and sc) else None,
            "mean_clr": float(np.mean(clearances[name])) if len(clearances[name]) else None,
            "std_clr": float(np.std(clearances[name])) if len(clearances[name]) else None,
        }
    df = pd.DataFrame(rows).T
    for col in ("ESA", "model", "score", "mean_clr", "std_clr"):
        df[col] = pd.to_numeric(df[col], errors="coerce")
    return df


class Model:
    """Facade mirroring the JAX package's ``Model`` on one device.

    It changes no process-wide setting: call ``runtime.setup_device`` first
    (as ``cli.predict`` does) to hold CUDA to the f32 parity contract.
    """

    def __init__(self, config: Dict[str, Any], device: str | torch.device = "cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.hrnet: Optional[HRNet] = None
        self.forward: Optional[_Forward] = None

    @property
    def _training(self) -> Dict[str, Any]:
        return self.config["training"]

    def load_checkpoint(self, checkpoint: str):
        """Load ``HRNet.pth`` (a file, or a run directory holding it)."""
        self.hrnet = load_model(self.config, checkpoint, self.device)
        self.forward = _Forward(self.hrnet, self.device)

    def set_params(self, state_dict: Mapping[str, torch.Tensor]):
        """Use in-memory weights (a reference-format state dict)."""
        self.hrnet = build_model(self.config, self.device)
        self.hrnet.load_state_dict(state_dict)
        self.forward = _Forward(self.hrnet, self.device)

    def load_checkpoint_with_shiftnet(self, checkpoint: str):
        raise NotImplementedError(NOT_PORTED["registration"])

    def load_ensemble(self, checkpoints, register: bool = True):
        raise NotImplementedError(NOT_PORTED["ensemble"])

    def enable_tta(self, transforms: int = 8, register: bool = True):
        raise NotImplementedError(NOT_PORTED["tta"])

    def __call__(self, imset, registered: bool = False):
        if registered:
            raise NotImplementedError(NOT_PORTED["registration"])
        return get_sr_and_score(
            imset,
            self.forward,
            min_l=self._training["min_L"],
            single_view_policy=self._training.get("single_view_policy", "warn"),
        )

    def evaluate(self, train_dataset, val_dataset, test_dataset, baseline_cpsnrs):
        scores, clearances, part = evaluate(
            self.forward,
            {"train": train_dataset, "val": val_dataset, "test": test_dataset},
            min_l=self._training["min_L"],
            single_view_policy=self._training.get("single_view_policy", "warn"),
        )
        return benchmark(baseline_cpsnrs, scores, part, clearances)

    def generate_submission_file(self, imset_dataset, out: str = "submission"):
        from highresnet_tpu_torch.eval.submission import generate_submission_file

        return generate_submission_file(
            self.forward, imset_dataset, out=out,
            min_l=self._training["min_L"],
            single_view_policy=self._training.get("single_view_policy", "warn"),
        )
