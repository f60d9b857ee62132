"""Best-model selection: EMA dual scoring, best-weights tracking, early stop.

The counterpart of ``highresnet_tpu/train/selection.py``:

- ``dual_candidates``: with training.ema_decay > 0 both the EMA and the raw
  weights are scored each epoch and the lower score wins;
- ``BestTracker``: snapshots winning weights to host memory (the next train
  step updates the live tensors in place) and saves them through the
  checkpoint manager;
- early stopping after ``patience`` epochs without improvement (0 = off).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple


def host_copy(tree):
    """Nested dicts of tensors -> the same dicts of detached CPU copies."""
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    return tree.detach().cpu().clone()


def dual_candidates(
    state, primary_score: float, eval_raw: Callable[[Any], float]
) -> Tuple[float, Any, Optional[float], Optional[float]]:
    """Pick the candidate weights for best-model selection this epoch.

    ``primary_score`` is the score of ``state.eval_params``. With EMA on,
    ``eval_raw`` scores the raw HRNet weights on the same val draw and the
    lower score wins. Returns (cand_score, cand_params, raw_val_score,
    ema_val_score); the last two are None when EMA is off.
    """
    if state.ema is None:
        return primary_score, state.eval_params, None, None
    raw_score = eval_raw(state.params["hrnet"])
    if raw_score < primary_score:
        return raw_score, state.params, raw_score, primary_score
    return primary_score, state.eval_params, raw_score, primary_score


class BestTracker:
    """Tracks the best validation score and epoch and the winning weights."""

    def __init__(self, ckpt, patience: int = 0):
        self.ckpt = ckpt
        self.patience = int(patience or 0)
        self.best_score = float("inf")
        self.best_epoch = 0
        self.best: Optional[Dict[str, Any]] = None  # host {"params", "batch_stats"}
        self.best_source = None  # "ema" | "raw" | None (EMA off)
        self.ema_wins = 0
        self.raw_wins = 0
        self.val_history = []  # [(epoch, score), ...], kept through checkpoints

    def seed(self, best, score: float = float("inf"), epoch: int = 0) -> None:
        """Initialise from a restore (or the fresh init weights)."""
        self.best = best
        self.best_score = score
        self.best_epoch = epoch

    def update(self, epoch: int, score: float, params, batch_stats) -> bool:
        """Record (and save) a new best; returns True when it improved."""
        if score >= self.best_score:
            return False
        self.best_score = score
        self.best_epoch = epoch
        self.best = host_copy({"params": params, "batch_stats": batch_stats})
        self.ckpt.save_best(self.best["params"], self.best["batch_stats"], score, epoch=epoch)
        return True

    def early_stop(self, epoch: int) -> bool:
        """True when ``patience`` epochs passed with no val improvement."""
        return self.patience > 0 and (epoch - self.best_epoch) >= self.patience

