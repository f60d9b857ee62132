"""Experiment-harness primitives for quality and ablation experiments.

The counterpart of ``highresnet_tpu/exp/harness.py``: building (or reusing)
a synthetic dataset, the held-out scenes of the standard split, the scoring
blocks (the bicubic baseline, a per-scene shift-cPSNR scorer, the SR
overflow), paired statistics and the report writer, plus what the drivers in
``highresnet_tpu_torch/examples/`` share: the weights of a training run as
a model (``model_from_params``; the drivers score it through the
evaluator's ``Forward`` with ``host=False``), a scored
scene's seeded view draw (``read_scene``), the MFSR / one-view / bicubic
scoring of held-out scenes (``mfsr_rows``), the
device label of a report (``device_label``) and the default report path
(``default_out``). An experiment holds only its arms and its protocol.

Scoring runs on the card unless the caller passes ``device="cpu"``. The
bicubic baseline is JAX's cubic (``ops/resize.py``), not
``F.interpolate(mode="bicubic")``, whose kernel differs by up to 0.075 at
16 -> 48 px. The JAX module's platform and compile-cache pinning
(``honor_platform_and_cache``) has no counterpart here.
"""

from __future__ import annotations

import json
import math
import os
import tempfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from highresnet_tpu_torch.ops.metrics import shift_cpsnr
from highresnet_tpu_torch.ops.resize import resize_cubic
from highresnet_tpu_torch.runtime import as_tensor, card_line, resolve_device

REPORT_DIR = os.path.join("build", "examples")
VIEW_SEED = 0  # the seeded draw of a scored scene's views (``read_scene``)


def default_out(name: str) -> str:
    """A driver's default report path, ``build/examples/<name>``: never a
    checked-in report of the JAX package."""
    return os.path.join(REPORT_DIR, name)


def default_root(name: str) -> str:
    """A driver's default dataset directory, ``<tmp>/<name>``."""
    return os.path.join(tempfile.gettempdir(), name)


def device_label(device: torch.device | str) -> str:
    """A report's ``device``: the card's name and power limit on CUDA
    (``runtime.card_line``), ``"cpu"`` on the CPU."""
    return card_line() if torch.device(device).type == "cuda" else "cpu"


def model_from_params(config, hrnet_params, device: torch.device | str):
    """HRNet at ``training.compute_dtype`` on ``device`` holding
    ``hrnet_params`` (``train_and_get_best_model``'s ``params["hrnet"]``)."""
    from highresnet_tpu_torch.models.network import build_network

    model = build_network(config, resolve_device(device))
    model.load_state_dict(hrnet_params)
    return model.eval()


def read_scene(scene_dir: str, views: int):
    """One scene for scoring: ``views`` views drawn by clearance, as the JAX
    drivers read it (``top_k=views, beta=50``), from a generator seeded with
    ``VIEW_SEED``, so a report repeats; the JAX drivers draw unseeded."""
    from highresnet_tpu_torch.data import read_imageset

    return read_imageset(scene_dir, top_k=views, beta=50.0,
                         rng=np.random.default_rng(VIEW_SEED))


def mfsr_rows(forward, scene_dirs: Sequence[str], views: int,
              device: torch.device | str = "cuda", log: bool = False) -> List[Dict]:
    """Per scene (``read_scene``): shift-cPSNR of the SR from ``views`` views
    (``mfsr``), from the first view alone (``one_view``) and of that view's
    3x bicubic upsample (``bicubic``)."""
    from highresnet_tpu_torch.data import collate

    rows = []
    for d in scene_dirs:
        s = read_scene(d, views)
        batch = collate([s], views)
        sr = forward(batch.lrs, batch.alphas)[0]
        one = collate([s], 1)
        sr1 = forward(one.lrs, one.alphas)[0]
        score = scene_scorer(s, device)
        rows.append({"scene": s.name, "mfsr": score(sr), "one_view": score(sr1),
                     "bicubic": score(bicubic_x3(s.lr[0], device))})
        if log:
            r = rows[-1]
            print(f"{s.name:<12} mfsr={r['mfsr']:6.2f} one={r['one_view']:6.2f} "
                  f"bicubic={r['bicubic']:6.2f}", flush=True)
    return rows


def ensure_dataset(
    root: str,
    *,
    scenes_per_channel: int,
    views: int,
    lr_size: int,
    seed: int,
    detail: float,
    hr_shift: float = 0.0,
    hr_shift_sigma: float = 0.0,
    regen: bool = False,
    pack: bool = True,
    write_norm_csv: bool = False,
) -> None:
    """Build (or reuse) a synthetic Proba-V-format dataset at ``root``.

    Rebuilds when ``regen`` is set or the tree is incomplete (a generator
    killed mid-write leaves no ``.complete`` marker); ``clear`` removes only
    generated files, so run directories under ``root`` survive. With
    ``pack``, writes the decode-free scene cache, topping up scenes that a
    killed run left unpacked.
    """
    from highresnet_tpu_torch.data import discover_scenes
    from highresnet_tpu_torch.data.pack import PACK_NAME, pack_scenes
    from highresnet_tpu_torch.data.synth import (
        clear_synthetic_dataset,
        make_synthetic_dataset,
        synthetic_dataset_complete,
    )

    if not regen and synthetic_dataset_complete(root):
        if pack:
            missing = [
                d for d in discover_scenes(os.path.join(root, "train"))
                if not os.path.exists(os.path.join(d, PACK_NAME))
            ]
            if missing:
                pack_scenes(missing)
                print(f"packed {len(missing)} unpacked scenes at {root}", flush=True)
        return
    clear_synthetic_dataset(root, force=regen)
    make_synthetic_dataset(
        root,
        n_scenes_per_channel=scenes_per_channel,
        n_views=views,
        lr_size=lr_size,
        seed=seed,
        splits=("train",),
        write_norm_csv=write_norm_csv,
        detail=detail,
        hr_shift=hr_shift,
        hr_shift_sigma=hr_shift_sigma,
    )
    print(f"dataset: {2 * scenes_per_channel} scenes at {root}", flush=True)
    if pack:
        from highresnet_tpu_torch.cli.pack_dataset import main as pack_main

        pack_main(["--prefix", root])


def held_out_scenes(
    root: str, val_proportion: float, max_scenes: Optional[int] = None
) -> List[str]:
    """The validation-side scene dirs of the standard split (seed 1): the
    scenes ``train_and_get_best_model`` holds out of training."""
    from highresnet_tpu_torch.data import discover_scenes, train_val_split

    scenes = discover_scenes(os.path.join(root, "train"))
    _, val = train_val_split(scenes, val_proportion, seed=1)
    return val if max_scenes is None else val[:max_scenes]


def bicubic_x3(img, device: torch.device | str = "cuda") -> torch.Tensor:
    """3x bicubic upsample of one (H, W) image, the no-learning baseline,
    as ``jax.image.resize(method="cubic")`` computes it. A tensor stays on
    its device; an array goes to ``device``."""
    img = as_tensor(img, device)
    h, w = img.shape
    return resize_cubic(img, (3 * h, 3 * w))


def scene_scorer(s, device: torch.device | str = "cuda") -> Callable:
    """Shift-cPSNR scorer for one ImageSet: ``score(img)`` clips to [0, 1]
    and runs the 7x7 integer search against the scene's HR and clearance
    map (``ops/metrics.py::shift_cpsnr``) on ``device``."""
    device = resolve_device(device)
    hr, hrm = as_tensor(s.hr, device), as_tensor(s.hr_map, device)
    return lambda img: float(shift_cpsnr(as_tensor(img, device).to(device).clamp(0, 1), hr, hrm))


def overflow_metrics(sr, border: int = 3) -> Tuple[float, float]:
    """(full, scored-region) out-of-[0, 1] overflow of a raw SR output: how
    far it leaves [0, 1] before the metric clips it, over the whole frame
    and inside the ``border`` px frame that shift_cpsnr trims."""
    sr = torch.as_tensor(sr, dtype=torch.float32)
    full = float(torch.maximum(torch.max(sr - 1.0), torch.max(-sr)))
    inner = sr[border:-border, border:-border]
    scored = float(torch.maximum(torch.max(inner - 1.0), torch.max(-inner)))
    return max(0.0, full), max(0.0, scored)


def paired_t(deltas: Sequence[float]) -> Optional[float]:
    """Paired t-statistic, or None when it is undefined (fewer than two
    samples, or deltas with zero variance)."""
    n = len(deltas)
    if n < 2:
        return None
    mean = sum(deltas) / n
    var = sum((d - mean) ** 2 for d in deltas) / (n - 1)
    se = math.sqrt(var / n)
    return mean / se if se > 0 else None


def paired_stats(a: Sequence[float], b: Sequence[float]) -> Dict:
    """Paired per-scene stats for score lists a vs b (a minus b)."""
    d = np.asarray(a) - np.asarray(b)
    n = len(d)
    t = float(d.mean() / (d.std(ddof=1) / math.sqrt(n))) if n > 1 else float("nan")
    return {
        "mean_db": round(float(d.mean()), 4),
        "wins": int((d > 0).sum()),
        "n": n,
        "paired_t": round(t, 2),
    }


def write_json(path: str, report: Dict) -> None:
    """Write a report as indented JSON, making its directory if need be."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=2)


def emit_report(path: str, report: Dict, slim_drop: Sequence[str] = ()) -> None:
    """Write the full report JSON (``write_json``); print it with the
    ``slim_drop`` keys left out (per-scene arrays belong in the file, not
    the console)."""
    write_json(path, report)
    slim = {k: v for k, v in report.items() if k not in slim_drop}
    print(json.dumps(slim, indent=2))
