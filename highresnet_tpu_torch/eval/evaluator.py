"""Inference and benchmarking: the serving path of the port.

The counterpart of ``highresnet_tpu/eval/evaluator.py``: ``load_data``,
``get_sr_and_score``, ``load_model``, ``evaluate``, ``benchmark`` and the
``Model`` facade, with the one serving forward behind them, ``Forward``:
one checkpoint, a checkpoint ensemble or x4/x8 dihedral TTA, the last two
PCC-registered to their first output by default, in eval mode without
autograd, returning numpy or, with ``host=False``, the tensor on the
model's device; ShiftNet-registered scoring; and the single-view bicubic
route through JAX's cubic resize (``ops/resize.py``). Everything runs on
the model's device: the SR forwards, the PCC alignment (its warp is the
Lanczos kernel K3 on CUDA), the registered warp (K3) and the shift-search
cPSNR.

The SR network is the one ``network.arch`` names (``models/network.py``).
A network that comes without ShiftNet (RAMS) serves plain
(``load_checkpoint`` or ``set_params``, then ``forward`` or ``__call__``);
TTA, ensembles and ShiftNet-registered scoring refuse it.

Two faults of the JAX evaluator are not carried over (ROADMAP hazard H5):
``Model.set_params`` and ``Model.load_checkpoint_with_shiftnet`` honour
``training.compute_dtype``, and the submission writer honours
``training.single_view_policy``.
"""

from __future__ import annotations

import itertools
import os
import sys
import warnings
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch
from torch import nn

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
from highresnet_tpu_torch.models.convert import SHIFTNET_NAME, load_weights
from highresnet_tpu_torch.models.layers import stacked_members
from highresnet_tpu_torch.models.network import build_network, weights_file, with_shiftnet
from highresnet_tpu_torch.models.shiftnet import ShiftNet, apply_shifts, register_views
from highresnet_tpu_torch.ops.dihedral import SAFE_SUBGROUP, dihedral_fwd, dihedral_inv
from highresnet_tpu_torch.ops.metrics import shift_cpsnr
from highresnet_tpu_torch.ops.resize import resize_cubic
from highresnet_tpu_torch.registration.search import pcc_align_batch
from highresnet_tpu_torch.runtime import resolve_device
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


class Forward:
    """The serving forward: (lrs, alphas) in, arrays or tensors; the
    (B, 3H, 3W) SR out, numpy or, with ``host=False``, on ``device``, where
    the models run. Its members are the forwards it averages, each a model
    under a dihedral element or as it is:

    - one model alone (``Forward.plain``): its SR, with no mean;
    - an ensemble (``Forward.ensemble``), each model as it is: the paper's
      HighRes-net+ entry ensembles two;
    - TTA (``Forward.tta``), one model under each D4 symmetry of the LR
      stack, the symmetry undone on its output. ``transforms=8`` needs
      square inputs; 4 uses the shape-safe subgroup.

    Several members are averaged. Consecutive members that share one model
    object (TTA's) run as forwards over their inputs stacked along the batch
    axis, each in its ``serve.stack`` span: for K such members and a batch of
    B, max(1, K // B) members a forward, so a forward holds at most max(B, K)
    scenes: one batch-8 forward for an x8 TTA scene. Every caller sends one
    scene a call; B > 1 has no measured caller, and the rule only keeps its
    memory to that of K scenes. Inside a stacked forward a conv with fewer
    than 8 samples a member runs once a member
    (``models.layers.stacked_members``), so each member's SR has the bits of
    its own forward. A member with a model of its own (an ensemble's) runs
    alone, in its ``serve.transform`` span. With
    ``register`` (default) each SR is first PCC-aligned to the first
    member's: independently trained models settle on output frames O(1 px)
    apart, and one model's output offset is not equivariant under the
    dihedral action, so a raw mean blurs (ENSEMBLE_REPORT.json,
    TTA_REPORT.json)."""

    def __init__(self, members: Sequence[Tuple[nn.Module, Optional[int]]], device: torch.device,
                 register: bool = True, host: bool = True):
        self.members = [(model.eval(), t) for model, t in members]
        self.device = device
        self.register = register
        self.host = host

    @classmethod
    def plain(cls, model: nn.Module, device: torch.device, host: bool = True) -> "Forward":
        return cls([(model, None)], device, host=host)

    @classmethod
    def ensemble(cls, models: Sequence[nn.Module], device: torch.device, register: bool = True,
                 host: bool = True) -> "Forward":
        """List the strongest model first: the others are aligned to it."""
        return cls([(m, None) for m in models], device, register, host)

    @classmethod
    def tta(cls, model: nn.Module, device: torch.device, transforms: int = 8,
            register: bool = True, host: bool = True) -> "Forward":
        if transforms not in (4, 8):
            raise ValueError(f"transforms must be 4 or 8, got {transforms}")
        elements = SAFE_SUBGROUP if transforms == 4 else tuple(range(8))
        return cls([(model, t) for t in elements], device, register, host)

    @staticmethod
    def _member(model: nn.Module, t: Optional[int], x: torch.Tensor,
                a: torch.Tensor) -> torch.Tensor:
        return model(x, a) if t is None else dihedral_inv(model(dihedral_fwd(x, t), a), t)

    def _forwards(self, x: torch.Tensor, a: torch.Tensor) -> list:
        """Every member's SR, in member order (the class notes)."""
        srs = []
        for _, run in itertools.groupby(self.members, key=lambda member: id(member[0])):
            run = list(run)
            if len(run) == 1:
                with span("serve.transform"):
                    srs.append(self._member(*run[0], x, a))
                continue
            model, size = run[0][0], max(1, len(run) // x.shape[0])
            for i in range(0, len(run), size):
                ts = [t for _, t in run[i:i + size]]
                with span("serve.stack"), stacked_members(len(ts)):
                    xs = torch.cat([x if t is None else dihedral_fwd(x, t) for t in ts])
                    out = model(xs, a.repeat(len(ts), 1)).split(x.shape[0])
                    srs += [sr if t is None else dihedral_inv(sr, t) for sr, t in zip(out, ts)]
        return srs

    @span("serve.call")
    def __call__(self, lrs, alphas):
        if (lrs.shape[-2] != lrs.shape[-1]
                and any(t not in (None, *SAFE_SUBGROUP) for _, t in self.members)):
            raise ValueError(
                "x8 TTA requires square inputs (90-degree rotations); "
                f"got {lrs.shape[-2]}x{lrs.shape[-1]} — use transforms=4"
            )
        with torch.inference_mode():
            with span("serve.to_device"):
                x = torch.as_tensor(lrs, dtype=torch.float32, device=self.device)
                a = torch.as_tensor(alphas, dtype=torch.float32, device=self.device)
            if len(self.members) == 1:
                sr = self._member(*self.members[0], x, a)
            else:
                sr = _register_and_average(self._forwards(x, a), self.register)
            with span("serve.to_host"):
                return sr.cpu().numpy() if self.host else sr


# the names perfbench/faults.py patches to plant a fault in the plain and TTA forwards
_Forward = _TTAForward = Forward


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


def load_model(config: Mapping[str, Any], checkpoint: str, device="cuda") -> nn.Module:
    """Build the SR network and load its weights, ``HRNet.pth`` or
    ``RAMS.pth`` (a file, or a directory holding it).

    A CUDA device that is missing raises before the checkpoint is read."""
    device = resolve_device(device)
    model = build_network(config, device)
    model.load_state_dict(load_weights(checkpoint, weights_file(config)))
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
        self.hrnet: Optional[nn.Module] = None  # the SR network, HRNet or RAMS
        self.forward: Optional[Forward] = None
        self.registration: Optional[ShiftNet] = None  # load_checkpoint_with_shiftnet

    @property
    def _training(self) -> Dict[str, Any]:
        return self.config["training"]

    def _hrnet_only(self, what: str) -> None:
        if not with_shiftnet(self.config):
            raise ValueError(f"{what} serves HRNet only; RAMS serves plain "
                             "(load_checkpoint or set_params, then forward or __call__)")

    def load_checkpoint(self, checkpoint: str):
        """Load ``HRNet.pth`` or ``RAMS.pth`` (a file, or a run directory holding it)."""
        self.hrnet = load_model(self.config, checkpoint, self.device)
        self.forward = Forward.plain(self.hrnet, self.device)

    def set_params(self, state_dict: Mapping[str, torch.Tensor]):
        """Use in-memory weights (a reference-format state dict)."""
        self.hrnet = build_network(self.config, self.device)
        self.hrnet.load_state_dict(state_dict)
        self.forward = Forward.plain(self.hrnet, self.device)

    def load_checkpoint_with_shiftnet(self, checkpoint: str):
        """Also load ShiftNet for registered scoring: HRNet from
        ``best/HRNet.pth`` at ``training.compute_dtype``, ShiftNet from
        ``best/ShiftNet.pth`` at ``register_size``, in eval mode. Takes a run
        directory of the port's cli.train or a directory holding both files."""
        self._hrnet_only("ShiftNet-registered scoring")
        path = next((p for p in (os.path.join(checkpoint, SHIFTNET_NAME),
                                 os.path.join(checkpoint, "best", SHIFTNET_NAME))
                     if os.path.isfile(p)), None)
        if path is None:
            raise FileNotFoundError(
                f"{checkpoint} holds no {SHIFTNET_NAME} (nor best/{SHIFTNET_NAME}); registered "
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
        mean: list the strongest model first."""
        self._hrnet_only("an ensemble")
        models = [load_model(self.config, c, self.device) for c in checkpoints]
        self.hrnet = models[-1]
        self.forward = Forward.ensemble(models, self.device, register=register)

    def enable_tta(self, transforms: int = 8, register: bool = True):
        """Wrap the loaded single-checkpoint forward in x4/x8 dihedral TTA
        (``Forward.tta``); call after load_checkpoint / set_params. Not
        available on an ensemble."""
        self._hrnet_only("TTA")
        if self.forward is None or len(self.forward.members) != 1:
            raise ValueError(
                "enable_tta requires a single-checkpoint forward "
                "(load_checkpoint/set_params first; not available on ensembles)"
            )
        self.forward = Forward.tta(self.hrnet, self.device, transforms=transforms,
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
