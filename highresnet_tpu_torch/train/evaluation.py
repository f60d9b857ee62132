"""Validation-set construction and scoring.

The counterpart of ``highresnet_tpu/train/evaluation.py``. With norm.csv
the val score is the mean of ESA / model cPSNR ratios (lower is better,
< 1 beats the ESA baseline); without it, the mean of −shift_cPSNR.

With ``shard=True`` (a multi-process run, eval batch a multiple of the
size of ``group``, the data group: None for every rank) each rank scores its
rows of every batch and the scores are all-gathered over the group in scene
order, so every rank computes the same val score. The view ranks of a 2-D
layout each score their replica's rows with the whole forward, as JAX's
eval runs over ``data`` only.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from highresnet_tpu_torch.data import collate, read_imageset
from highresnet_tpu_torch.parallel.distributed import all_gather, process_count, process_index


def build_val_batches(
    val_scenes,
    min_l: int,
    top_k: int,
    beta: float,
    batch_size: int,
    rng=None,
    truncate_to: Optional[int] = None,
):
    """Pre-collate the validation set into fixed-shape batches.

    A seeded ``rng`` freezes the clearance-sampled view selection, so the
    val score is deterministic across epochs and runs. ``truncate_to=k``
    keeps each scene's k clearest views (alpha zero-pads back to min_l). A
    short last batch repeats its last scene; the names list only the real
    ones. Returns [(names, (lrs, alphas, hrs, hr_maps))] of numpy arrays.
    """
    out = []
    for start in range(0, len(val_scenes), batch_size):
        dirs = val_scenes[start : start + batch_size]
        sets = [read_imageset(d, top_k=top_k, beta=beta, rng=rng) for d in dirs]
        if truncate_to is not None and truncate_to < min_l:
            sets = [
                dataclasses.replace(s, lr=s.lr[:truncate_to], clearances=s.clearances[:truncate_to])
                for s in sets
            ]
        n_real = len(sets)
        if n_real < batch_size:
            sets = sets + [sets[-1]] * (batch_size - n_real)
        batch = collate(sets, min_l)
        out.append((batch.names[:n_real], (batch.lrs, batch.alphas, batch.hrs, batch.hr_maps)))
    return out


def evaluate_model(
    params_hrnet,
    eval_step,
    val_scenes,
    min_l: int,
    baseline_cpsnrs: Optional[Dict[str, float]],
    top_k: int,
    beta: float,
    batch_size: int = 1,
    return_images: bool = False,
    prebuilt_batches=None,
    sample_rng=None,
    device: torch.device | str = "cuda",
    shard: bool = False,
    group=None,
):
    """Validation score over full-resolution scenes.

    Scenes absent from norm.csv or scoring a non-positive cPSNR are skipped
    with a warning. Every batch is dispatched first and the scores are read
    back once at the end. With return_images=True also returns (sr0, hr0)
    of the first scene, for TensorBoard.
    """
    batches = prebuilt_batches
    if batches is None:
        batches = build_val_batches(val_scenes, min_l, top_k, beta, batch_size, rng=sample_rng)
    pending = []  # (names, device scores)
    first_srs = first_hr = None
    rank, world = (process_index(group), process_count(group)) if shard else (0, 1)
    for names, host_args in batches:
        rows, ragged = divmod(len(host_args[0]), world)
        if ragged:
            raise ValueError(f"eval batch {len(host_args[0])} does not split over {world} ranks")
        args = [torch.from_numpy(a[rank * rows:(rank + 1) * rows]).to(device) for a in host_args]
        srs, scores = eval_step(params_hrnet, *args)
        if return_images and first_srs is None:
            first_srs, first_hr = srs, host_args[2][0]
        pending.append((names, scores))
    if shard and pending:  # one gather: (world, batches, rows) -> each batch in scene order
        gathered = all_gather(torch.stack([scores for _, scores in pending]), group)
        scores = gathered.transpose(0, 1).reshape(len(pending), -1)
        pending = [(names, s) for (names, _), s in zip(pending, scores)]

    total, n = 0.0, 0
    for names, scores in pending:
        for name, s in zip(names, scores.tolist()):
            if baseline_cpsnrs is not None and name not in baseline_cpsnrs:
                warnings.warn(f"scene {name!r} missing from norm.csv; skipped in val score")
                continue
            if s <= 0.0 or not np.isfinite(s):
                warnings.warn(f"scene {name!r} scored non-positive cPSNR {s}; skipped")
                continue
            total += baseline_cpsnrs[name] / s if baseline_cpsnrs is not None else -s
            n += 1
    if n == 0:
        warnings.warn("no scorable validation scenes; returning +inf val score")
    score = total / n if n else float("inf")
    if return_images:
        sr0 = first_srs[0].cpu().numpy() if first_srs is not None else None
        return score, sr0, first_hr
    return score
