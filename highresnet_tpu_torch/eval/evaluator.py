"""Inference and benchmarking: the serving path of the port.

The counterpart of ``highresnet_tpu/eval/evaluator.py``: ``load_data``,
``get_sr_and_score``, ``load_model``, ``evaluate``, ``benchmark`` and the
``Model`` facade, with the forwards behind them: one checkpoint
(``_Forward``), a checkpoint ensemble (``_EnsembleForward``) and x4/x8
dihedral TTA (``_TTAForward``), both PCC-registered to their first output
by default, each in eval mode without autograd, returning numpy or, with
``host=False``, the tensor on the model's device; ShiftNet-registered
scoring; and the single-view bicubic route through JAX's cubic resize (``ops/resize.py``). Everything runs on the
model's device: the SR forwards, the PCC alignment (its warp is the Lanczos
kernel K3 on CUDA), the registered warp (K3) and the shift-search cPSNR.

Two faults of the JAX evaluator are not carried over (ROADMAP hazard H5):
``Model.set_params`` and ``Model.load_checkpoint_with_shiftnet`` honour
``training.compute_dtype``, and the submission writer honours
``training.single_view_policy``.
"""

from __future__ import annotations

import os
import sys
import warnings
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

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
from highresnet_tpu_torch.models.shiftnet import ShiftNet, apply_shifts, register_views
from highresnet_tpu_torch.ops.dihedral import SAFE_SUBGROUP, dihedral_fwd, dihedral_inv
from highresnet_tpu_torch.ops.metrics import shift_cpsnr
from highresnet_tpu_torch.ops.resize import resize_cubic
from highresnet_tpu_torch.registration.search import pcc_align_batch
from highresnet_tpu_torch.runtime import compute_dtypes, resolve_device
from highresnet_tpu_torch.train.checkpoint import SHIFTNET_FILE
from highresnet_tpu_torch.utils.profiling import span


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


def _device_batch(lrs, alphas, device: torch.device):
    """(lrs, alphas), arrays or tensors, as float32 tensors on ``device``."""
    with span("serve.to_device"):
        return (torch.as_tensor(lrs, dtype=torch.float32, device=device),
                torch.as_tensor(alphas, dtype=torch.float32, device=device))


def _out(sr: torch.Tensor, host: bool):
    with span("serve.to_host"):
        return sr.cpu().numpy() if host else sr


def _register_and_average(srs: Sequence[torch.Tensor], register: bool) -> torch.Tensor:
    """Mean of (B, H, W) SR outputs, each first PCC-aligned to ``srs[0]``
    with ``register``: one alignment call (one K3 launch on CUDA) over
    the (K-1)·B non-anchor images. K3 takes float32, so each SR is cast."""
    with span("serve.align"):
        srs = [sr.to(torch.float32) for sr in srs]
        if register and len(srs) > 1:
            anchor = srs[0]
            aligned, _ = pcc_align_batch(anchor.repeat(len(srs) - 1, 1, 1), torch.cat(srs[1:]))
            srs = [anchor, *aligned.split(anchor.shape[0])]
        return torch.stack(srs).mean(dim=0)


class _Forward:
    """(lrs, alphas) in, arrays or tensors; the (B, 3H, 3W) SR out, numpy
    or, with ``host=False``, on ``device``, where the model runs."""

    def __init__(self, model: HRNet, device: torch.device, host: bool = True):
        self.model = model.eval()
        self.device = device
        self.host = host

    @span("serve.call")
    def __call__(self, lrs, alphas):
        with torch.inference_mode():
            return _out(self.model(*_device_batch(lrs, alphas, self.device)), self.host)


class _EnsembleForward:
    """The mean SR of several weight sets (the paper's HighRes-net+ entry
    ensembles two models). With ``register`` (default) every member's SR is
    PCC-aligned to the first member's before averaging: independently
    trained members settle on output frames O(1 px) apart, so a raw mean
    blurs (ENSEMBLE_REPORT.json)."""

    def __init__(self, models: Sequence[HRNet], device: torch.device, register: bool = True,
                 host: bool = True):
        self.models = [m.eval() for m in models]
        self.device = device
        self.register = register
        self.host = host

    @span("serve.call")
    def __call__(self, lrs, alphas):
        with torch.inference_mode():
            x, a = _device_batch(lrs, alphas, self.device)
            srs = []
            for m in self.models:
                with span("serve.transform"):
                    srs.append(m(x, a))
            return _out(_register_and_average(srs, self.register), self.host)


class _TTAForward:
    """Geometric self-ensemble around one weight set: the SR of each D4
    symmetry of the LR stack, the symmetry undone on the output, the mean.
    With ``register`` (default) the outputs are PCC-aligned to the identity
    transform's first: the model's O(1 px) output offset is not equivariant
    under the dihedral action, so a raw mean blurs (TTA_REPORT.json).
    ``transforms=8`` needs square inputs; 4 uses the shape-safe subgroup."""

    def __init__(self, model: HRNet, device: torch.device, transforms: int = 8,
                 register: bool = True, host: bool = True):
        if transforms not in (4, 8):
            raise ValueError(f"transforms must be 4 or 8, got {transforms}")
        self.model = model.eval()
        self.device = device
        self.transforms = transforms
        self.register = register
        self.host = host
        self.elements = SAFE_SUBGROUP if transforms == 4 else tuple(range(8))

    @span("serve.call")
    def __call__(self, lrs, alphas):
        if self.transforms == 8 and lrs.shape[-2] != lrs.shape[-1]:
            raise ValueError(
                "x8 TTA requires square inputs (90-degree rotations); "
                f"got {lrs.shape[-2]}x{lrs.shape[-1]} — use transforms=4"
            )
        with torch.inference_mode():
            x, a = _device_batch(lrs, alphas, self.device)
            srs = []
            for t in self.elements:
                with span("serve.transform"):
                    srs.append(dihedral_inv(self.model(dihedral_fwd(x, t), a), t))
            return _out(_register_and_average(srs, self.register), self.host)


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


def _score(sr: torch.Tensor, batch: Batch) -> float:
    """shift_cPSNR of the clipped SR against the batch's first HR, on sr's device."""
    device = sr.device
    return float(shift_cpsnr(sr.clamp(0.0, 1.0), torch.from_numpy(batch.hrs[0]).to(device),
                             torch.from_numpy(batch.hr_maps[0]).to(device)))


def register_sr(shiftnet: ShiftNet, sr: torch.Tensor, hr: torch.Tensor,
                register_size: int) -> torch.Tensor:
    """The registered-scoring warp: ShiftNet's shift of the SR against its HR
    on their central ``register_size`` crops, applied to the whole SR by
    ``apply_shifts`` (one (B·L, H, W) = (1, H, W) warp: K3 on CUDA)."""
    if sr.shape[-1] < register_size:
        raise ValueError(f"registered eval needs SR >= {register_size}px (got {sr.shape[-1]})")
    off = (sr.shape[-1] - register_size) // 2
    crop = slice(off, off + register_size)
    thetas = register_views(shiftnet, sr[None, None, crop, crop], hr[None, crop, crop])
    return apply_shifts(sr[None, None], thetas)[0, 0]


def get_sr_and_score(
    imset: ImageSet | Batch,
    forward,
    min_l: int = 16,
    registration: Optional[ShiftNet] = None,
    register_size: int = 128,
    single_view_policy: str = "warn",
) -> Tuple[np.ndarray, Optional[float]]:
    """Super-resolve one scene and (if HR exists) its shift_cPSNR.

    With ``registration`` (a ShiftNet on the forward's device, in eval mode)
    the SR is first registered against its HR and warped before scoring; the
    integer shift search still runs on top, as in training-time validation.

    ``single_view_policy`` governs scenes with exactly one real view: "warn"
    runs the model and warns (fusion at L=1 measures below bicubic),
    "bicubic" returns JAX's 3x cubic resize of the clearest view instead,
    "model" runs the model silently.
    """
    with span("serve.scene"):
        with span("serve.collate"):
            batch = collate([imset], min_l) if isinstance(imset, ImageSet) else imset
        device = getattr(forward, "device", torch.device("cpu"))
        n_real_views = float(np.sum(np.asarray(batch.alphas[0])))
        if n_real_views <= 1.0 and single_view_policy != "model":
            if single_view_policy == "bicubic":
                # the clearest view (read_imageset orders views by clearance)
                lr = torch.from_numpy(np.asarray(batch.lrs[0, 0], np.float32)).to(device)
                with torch.inference_mode():
                    sr_t = resize_cubic(lr, (3 * lr.shape[0], 3 * lr.shape[1]))
                    score = None if batch.hrs is None else _score(sr_t, batch)
                return sr_t.cpu().numpy(), score
            warnings.warn(
                "single-view scene: multi-frame fusion measures below plain "
                "bicubic at L=1 (paper Fig. 1). Set training.single_view_policy="
                "'model' to silence this.",
                RuntimeWarning,
                stacklevel=3,
            )
        sr = forward(batch.lrs, batch.alphas)[0]
        with span("serve.range_check"):
            warn_out_of_range(sr, name=batch.names[0] if batch.names else "")
            score = None
            if batch.hrs is not None:
                with torch.inference_mode():
                    sr_t = torch.from_numpy(sr).to(device)
                    if registration is not None:
                        hr = torch.from_numpy(batch.hrs[0]).to(device)
                        sr_t = register_sr(registration, sr_t, hr, register_size)
                    score = _score(sr_t, batch)
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
    registration: Optional[ShiftNet] = None,
    register_size: int = 128,
    single_view_policy: str = "warn",
):
    """Score every scene in every split (ShiftNet-registered with
    ``registration``). Returns (scores, clearances, part)."""
    scores, clearances, part = {}, {}, {}
    for split, ds in datasets.items():
        for i, imset in enumerate(ds):
            _, sc = get_sr_and_score(
                imset, forward, min_l=min_l, registration=registration,
                register_size=register_size, single_view_policy=single_view_policy,
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
        self.forward = None  # _Forward, _EnsembleForward or _TTAForward
        self.registration: Optional[ShiftNet] = None  # load_checkpoint_with_shiftnet

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
        """Also load ShiftNet for registered scoring: HRNet from
        ``best/HRNet.pth`` at ``training.compute_dtype``, ShiftNet from
        ``best/ShiftNet.pth`` at ``register_size``, in eval mode. Takes a run
        directory of the port's cli.train or a directory holding both files."""
        path = next((p for p in (os.path.join(checkpoint, SHIFTNET_FILE),
                                 os.path.join(checkpoint, "best", SHIFTNET_FILE))
                     if os.path.isfile(p)), None)
        if path is None:
            raise FileNotFoundError(
                f"{checkpoint} holds no {SHIFTNET_FILE} (nor best/{SHIFTNET_FILE}); registered "
                "scoring takes a run directory of the port's cli.train, or a JAX run directory "
                "after scripts/export_torch_weights.py"
            )
        self.load_checkpoint(checkpoint)
        shiftnet = ShiftNet(register_size=self._training.get("register_size", 128))
        shiftnet.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
        self.registration = shiftnet.to(self.device).eval()

    def load_ensemble(self, checkpoints: Sequence[str], register: bool = True):
        """Average the SR of several checkpoints (HighRes-net+). ``register``
        aligns every member to the first member's output frame before the
        mean (``_EnsembleForward``): list the strongest model first."""
        models = [load_model(self.config, c, self.device) for c in checkpoints]
        self.hrnet = models[-1]
        self.forward = _EnsembleForward(models, self.device, register=register)

    def enable_tta(self, transforms: int = 8, register: bool = True):
        """Wrap the loaded single-checkpoint forward in x4/x8 dihedral TTA
        (``_TTAForward``); call after load_checkpoint / set_params. Not
        available on an ensemble."""
        if not isinstance(self.forward, _Forward):
            raise ValueError(
                "enable_tta requires a single-checkpoint forward "
                "(load_checkpoint/set_params first; not available on ensembles)"
            )
        self.forward = _TTAForward(self.hrnet, self.device, transforms=transforms,
                                   register=register)

    def __call__(self, imset, registered: bool = False):
        if registered and self.registration is None:
            raise ValueError("registered scoring needs load_checkpoint_with_shiftnet first")
        return get_sr_and_score(
            imset,
            self.forward,
            min_l=self._training["min_L"],
            registration=self.registration if registered else None,
            register_size=self._training.get("register_size", 128),
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
