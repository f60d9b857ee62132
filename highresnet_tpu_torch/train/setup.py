"""Training-run setup: the train loader, the models, the state and the steps.

The counterpart of ``highresnet_tpu/train/setup.py`` on one device. The
loader is the JAX package's own ``BatchLoader`` (host code, JAX-free).
Not ported yet, and refused with ``NotImplementedError`` naming the
ROADMAP item: ``training.mesh`` and multi-device data parallelism,
``training.epoch_cache_variants``, ``training.init_params_from`` and the
ShiftNet warm-start ``training.shiftnet_warmup_steps``.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from highresnet_tpu_torch.data import BatchLoader
from highresnet_tpu_torch.train.state import TrainState, create_train_state
from highresnet_tpu_torch.train.step import build_eval_step, build_train_step

NOT_PORTED = {
    "mesh": "training.mesh (multi-device training) is not ported yet (ROADMAP queue 1, item 9)",
    "epoch_cache_variants": (
        "training.epoch_cache_variants (the mmap epoch cache) is not ported yet "
        "(ROADMAP queue 1, item 7)"
    ),
    "init_params_from": (
        "training.init_params_from (fine-tune from a run's best/) is not ported yet "
        "(ROADMAP queue 1, item 7)"
    ),
    "shiftnet_warmup_steps": (
        "training.shiftnet_warmup_steps (the ShiftNet warm-start, train/pretrain.py) is "
        "not ported yet (ROADMAP queue 1, item 7)"
    ),
}


def check_supported(t: Dict[str, Any]) -> None:
    """Raise for a training option this port does not run yet."""
    for key, message in NOT_PORTED.items():
        if t.get(key):
            raise NotImplementedError(message)


def build_train_loader(t: Dict[str, Any], train_list: List[str], *, seed: int) -> BatchLoader:
    return BatchLoader(
        train_list,
        batch_size=t["batch_size"],
        min_l=t["min_L"],
        top_k=t["n_views"],
        beta=t["beta"],
        create_patches=t.get("create_patches", True),
        patch_size=t["patch_size"],
        shuffle=t.get("shuffle", True),
        seed=seed,
        num_workers=t.get("n_workers", 4),
        drop_last=False,
        augment=t.get("augment_dihedral", False),
        variable_views_p=float(t.get("variable_views_p", 0.0) or 0.0),
    )


class RunPieces(NamedTuple):
    state: TrainState
    train_step: Callable
    warm_train_step: Optional[Callable]  # registration-curriculum step (or None)
    register_warmup: int
    eval_step: Callable
    eval_batch: int


def build_models_and_steps(config: Dict[str, Any], device: torch.device, *, seed: int) -> RunPieces:
    """The train state (models drawn from ``seed``) and the train/eval steps.

    With ``register_warmup_epochs > 0`` the first epochs use a step built
    with ``register=False`` (the registration curriculum)."""
    t = config["training"]
    check_supported(t)
    state = create_train_state(config, device, torch.Generator().manual_seed(seed))
    train_step = build_train_step(config)
    register_warmup = int(t.get("register_warmup_epochs", 0) or 0)
    warm_train_step = None
    if register_warmup > 0 and t.get("register", True):
        warm_cfg = copy.deepcopy(config)
        warm_cfg["training"]["register"] = False
        warm_train_step = build_train_step(warm_cfg)
    eval_step = build_eval_step(state.hrnet)
    return RunPieces(state, train_step, warm_train_step, register_warmup, eval_step,
                     t.get("eval_batch_size", 1))
