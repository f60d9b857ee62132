"""Resumable checkpointing with ``torch.save``.

The counterpart of ``highresnet_tpu/train/checkpoint.py``. The full train
state (both models, BatchNorm buffers, Adam state, dropout generator, step,
EMA) goes into one of two alternating slots, ``state_0/`` and ``state_1/``;
``latest.json`` (the slot pointer plus the host state: epoch, best score,
scheduler, val history) is written only after the slot's file is complete.
So at any instant one complete, pointed-to checkpoint is on disk, and a
crash mid-save costs at most one save interval. Every file is written to a
temporary name and renamed into place.

``best/`` holds the best weights for inference in the reference's formats,
``HRNet.pth`` and ``ShiftNet.pth`` (state dicts, BatchNorm buffers
included), with ``best_score.json`` beside them; all written synchronously.

In a multi-process run the state is replicated: rank 0 alone writes, every
rank then waits at a barrier, and a resume reads the run directory (shared
storage) on every rank.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from highresnet_tpu_torch.parallel.distributed import barrier, process_index

STATE_FILE = "state.pt"
HRNET_FILE = "HRNet.pth"
SHIFTNET_FILE = "ShiftNet.pth"
_BUFFER_SUFFIXES = (".running_mean", ".running_var", ".num_batches_tracked")


def _atomic(path: str, write) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    write(tmp)
    os.replace(tmp, path)


def _save(obj, path: str) -> None:
    _atomic(path, lambda tmp: torch.save(obj, tmp))


def _write_json(obj, path: str) -> None:
    def write(tmp):
        with open(tmp, "w") as f:
            json.dump(obj, f)

    _atomic(path, write)


def _load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    def __init__(self, run_dir: str):
        self.run_dir = os.path.abspath(run_dir)
        self.primary = process_index() == 0
        if self.primary:
            os.makedirs(self.run_dir, exist_ok=True)
        self._last_slot = self._read_latest().get("slot", "state_1")

    def _path(self, *parts: str) -> str:
        return os.path.join(self.run_dir, *parts)

    def _read_latest(self) -> Dict[str, Any]:
        try:
            with open(self._path("latest.json")) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return {}

    # -- full resumable state ------------------------------------------------

    def save_state(self, state, host_state: Dict[str, Any]) -> None:
        """Save into the slot latest.json does NOT point to, then point to it."""
        slot = "state_0" if self._last_slot != "state_0" else "state_1"
        if self.primary:
            os.makedirs(self._path(slot), exist_ok=True)
            _save(state.state_dict(), self._path(slot, STATE_FILE))
            _write_json({"slot": slot, **host_state}, self._path("latest.json"))
        self._last_slot = slot
        barrier()

    def restore_state(self, state) -> Optional[Dict[str, Any]]:
        """Load the pointed-to slot into ``state``; returns the host state,
        or None when there is nothing to resume."""
        latest = self._read_latest()
        slot = latest.get("slot")
        if not slot or not os.path.isfile(self._path(slot, STATE_FILE)):
            return None
        try:
            state.load_state_dict(_load(self._path(slot, STATE_FILE)))
        except (RuntimeError, KeyError, ValueError) as e:
            raise RuntimeError(
                f"checkpoint at {self._path(slot)} does not match the current train "
                "state. Did a config knob that changes the state (training.ema_decay, "
                "network or register sizes) change since the run was checkpointed? "
                "Resume with the original settings, or start a fresh run_dir."
            ) from e
        return {k: v for k, v in latest.items() if k != "slot"}

    # -- best weights for inference ------------------------------------------

    def save_best(self, params, batch_stats, score: float, epoch: Optional[int] = None) -> None:
        """Synchronous: ``best/`` is complete on return."""
        if self.primary:
            os.makedirs(self._path("best"), exist_ok=True)
            _save(params["hrnet"], self._path("best", HRNET_FILE))
            _save({**params["shiftnet"], **batch_stats}, self._path("best", SHIFTNET_FILE))
            meta = {"score": float(score)}
            if epoch is not None:
                meta["epoch"] = int(epoch)
            _write_json(meta, self._path("best_score.json"))
        barrier()

    def has_best(self) -> bool:
        return all(os.path.isfile(self._path("best", f)) for f in (HRNET_FILE, SHIFTNET_FILE))

    def load_best(self) -> Dict[str, Any]:
        """{"params": {"hrnet", "shiftnet"}, "batch_stats"} from ``best/``."""
        shiftnet = _load(self._path("best", SHIFTNET_FILE))
        stats = {k: v for k, v in shiftnet.items() if k.endswith(_BUFFER_SUFFIXES)}
        return {
            "params": {
                "hrnet": _load(self._path("best", HRNET_FILE)),
                "shiftnet": {k: v for k, v in shiftnet.items() if k not in stats},
            },
            "batch_stats": stats,
        }

    def read_best_score(self) -> Dict[str, Any]:
        """The sidecar written with ``best/``: it labels those exact weights,
        where latest.json's best_score can be older after a crash."""
        try:
            with open(self._path("best_score.json")) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return {}


def resume_run(ckpt: CheckpointManager, state, tracker, scheduler):
    """Restore a run's full state for relaunch; returns (state, start_epoch).

    Seeds ``tracker`` from the SAVED best weights, labelled by the
    best_score.json sidecar when it is at least as good as latest.json's
    score, and restores the scheduler and the val history.
    """
    host_state = ckpt.restore_state(state)
    if host_state is None:
        return state, 1
    start_epoch = host_state.get("epoch", 0) + 1
    best = tracker.best
    best_score = host_state.get("best_score", float("inf"))
    best_epoch = host_state.get("best_epoch", start_epoch - 1)
    if ckpt.has_best():
        best = ckpt.load_best()
        meta = ckpt.read_best_score()
        if "score" in meta and meta["score"] <= best_score:
            best_score = meta["score"]
            best_epoch = meta.get("epoch", best_epoch)
    tracker.seed(best, best_score, best_epoch)
    tracker.val_history = [(int(e), float(s)) for e, s in host_state.get("val_history", [])]
    if "scheduler" in host_state:
        scheduler.load_state_dict(host_state["scheduler"])
    return state.with_learning_rate(scheduler.lr), start_epoch
