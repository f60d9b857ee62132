"""Training-run setup: the train loader, the models, the state and the steps.

The counterpart of ``highresnet_tpu/train/setup.py``, for one process of a
data-parallel run (``parallel/mesh.py::DataParallel``; one process alone by
default):

- ``build_train_loader``: the port's ``BatchLoader`` over this replica's
  shard of the train list at the local batch, seeded ``seed + 7919 · d``
  (d the data index: the view ranks of one replica read the same batches),
  dropping ragged batches when there are several ranks or a
  ``training.mesh``, wrapped in the mmap ``EpochCache`` when
  ``training.epoch_cache_variants > 0``, under the JAX package's cache key;
- ``build_models_and_steps``: the seeded train state, the weights of
  ``training.init_params_from`` (another run's ``best/``), the ShiftNet
  warm-start (``training.shiftnet_warmup_steps``, from the global list on
  every rank), the check that the ranks start identical, the train/eval
  steps (the train step view-sharded under a view axis), and the eval
  batch rounded up to a multiple of the data size.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from highresnet_tpu_torch.data import BatchLoader
from highresnet_tpu_torch.data.pipeline import EpochCache
from highresnet_tpu_torch.parallel.distributed import assert_replicated
from highresnet_tpu_torch.parallel.mesh import DataParallel, setup_data_parallel
from highresnet_tpu_torch.train.checkpoint import CheckpointManager
from highresnet_tpu_torch.train.epoch import warp_window_px
from highresnet_tpu_torch.train.pretrain import hr_crop_pool, pretrain_shiftnet
from highresnet_tpu_torch.train.state import TrainState, create_train_state
from highresnet_tpu_torch.train.step import build_eval_step, build_train_step


def one_process(t: Dict[str, Any]) -> DataParallel:
    """The layout of a run without a process group."""
    return DataParallel(rank=0, world=1, synced=False, local_batch=t["batch_size"])


def build_train_loader(t: Dict[str, Any], train_list: List[str], *, seed: int, data_dir: str,
                       layout: Optional[DataParallel] = None):
    """The train loader over ``train_list`` (this rank's shard); an
    ``EpochCache`` over it with epoch_cache_variants > 0, under
    ``epoch_cache_dir`` or ``<data_dir>/.epoch_cache``."""
    layout = layout or one_process(t)
    loader = BatchLoader(
        train_list,
        batch_size=layout.local_batch,
        min_l=t["min_L"],
        top_k=t["n_views"],
        beta=t["beta"],
        create_patches=t.get("create_patches", True),
        patch_size=t["patch_size"],
        shuffle=t.get("shuffle", True),
        seed=seed + 7919 * layout.d,  # decorrelate the replicas' view/patch sampling
        num_workers=t.get("n_workers", 4),
        drop_last=layout.drop_last,
        augment=t.get("augment_dihedral", False),
        variable_views_p=float(t.get("variable_views_p", 0.0) or 0.0),
    )
    cache_variants = int(t.get("epoch_cache_variants", 0) or 0)
    if cache_variants <= 0:
        return loader
    proto_key = (
        f"b{layout.local_batch}_L{t['min_L']}_k{t['n_views']}_p{t['patch_size']}"
        f"_c{int(t.get('create_patches', True))}_sh{int(t.get('shuffle', True))}"
        f"_d{int(layout.drop_last)}_s{seed}_h{layout.d}_n{len(train_list)}"
        f"_a{int(t.get('augment_dihedral', False))}_be{t['beta']:g}"
        f"_vv{float(t.get('variable_views_p', 0.0) or 0.0):g}"
    )
    cache_dir = os.path.join(
        t.get("epoch_cache_dir") or os.path.join(data_dir, ".epoch_cache"), proto_key
    )
    return EpochCache(loader, cache_dir, n_variants=cache_variants)


class RunPieces(NamedTuple):
    state: TrainState
    train_step: Callable
    warm_train_step: Optional[Callable]  # registration-curriculum step (or None)
    register_warmup: int
    eval_step: Callable
    eval_batch: int
    eval_shard: bool  # each replica scores its rows of every val batch


@torch.no_grad()
def _restart_ema(state: TrainState, model_names=("hrnet", "shiftnet")) -> None:
    """Point the EMA of the named models (those the state has) at their current weights."""
    if state.ema is None:
        return
    for name, model in state.models.items():
        if name in model_names:
            for k, p in model.named_parameters():
                state.ema[name][k].copy_(p)


def load_init_params(state: TrainState, run_dir: str, config: Dict[str, Any]) -> None:
    """Fine-tune start: the models' weights and ShiftNet's BatchNorm
    statistics from ``run_dir``'s ``best/``, the EMA restarted there. The
    optimizer stays fresh; the schedule and epoch count are the new run's."""
    best = os.path.join(run_dir, "best")
    donor = CheckpointManager.for_config(run_dir, config)
    missing = [f for f in donor.best_files if not os.path.isfile(os.path.join(best, f))]
    if missing:
        raise FileNotFoundError(
            f"training.init_params_from={run_dir!r}: {best} holds no {' or '.join(missing)}. "
            "It takes a run directory of the port's cli.train, or a JAX run directory (Orbax "
            "best/) after scripts/export_torch_weights.py has written both files into best/"
        )
    restored = donor.load_best()
    state.hrnet.load_state_dict(restored["params"]["hrnet"])
    if state.shiftnet is not None:
        state.shiftnet.load_state_dict({**restored["params"]["shiftnet"],
                                        **restored["batch_stats"]})
    _restart_ema(state)


def maybe_warmstart_shiftnet(state: TrainState, t: Dict[str, Any], train_list: List[str],
                             seed: int, is_primary: bool = True) -> Optional[float]:
    """The ShiftNet warm-start of ``training.shiftnet_warmup_steps`` (registered
    runs only), from the global train list with generator ``seed + 1``, on
    the warp window the registered loss uses; the EMA's ShiftNet restarts at
    the warm-started point. Returns the final shift RMSE (None: no warm-start)."""
    steps = int(t.get("shiftnet_warmup_steps", 0) or 0)
    if steps <= 0 or not t.get("register", True):
        return None
    pool = hr_crop_pool(train_list, t.get("register_size", 128))
    rmse = pretrain_shiftnet(
        state.shiftnet,
        pool,
        torch.Generator().manual_seed(seed + 1),
        steps=steps,
        sigma=t.get("shiftnet_warmup_sigma", 1.5),
        max_shift=warp_window_px(t),
        warp_int_range=int(t.get("warp_int_range", 0) or 0),
        use_pallas_warp=bool(t.get("use_pallas_warp", False)),
    )
    _restart_ema(state, ("shiftnet",))
    if is_primary:
        print(f"shiftnet warm-start: {steps} steps on {len(pool)} HR crops, final shift RMSE "
              f"{rmse:.3f} px", flush=True)
    return rmse


def replicated_groups(state: TrainState) -> Dict[str, Any]:
    """What must be identical on every rank: each model (parameters and
    buffers) and the dropout generator."""
    return {**{name: model.state_dict().values() for name, model in state.models.items()},
            "generator": [state.generator.get_state()]}


def build_models_and_steps(config: Dict[str, Any], device: torch.device, *, seed: int,
                           train_list: List[str],
                           layout: Optional[DataParallel] = None) -> RunPieces:
    """The train state (models drawn from ``seed``, then ``init_params_from``'s
    weights and the ShiftNet warm-start) and the train/eval steps.

    With ``register_warmup_epochs > 0`` the first epochs use a step built
    with ``register=False`` (the registration curriculum)."""
    t = config["training"]
    layout = layout or setup_data_parallel(t, device)
    state = create_train_state(config, device, torch.Generator().manual_seed(seed))
    init_from = t.get("init_params_from") or ""
    if init_from:
        load_init_params(state, init_from, config)
        if layout.primary:
            print(f"init: params loaded from {init_from}/best", flush=True)
    maybe_warmstart_shiftnet(state, t, train_list, seed, is_primary=layout.primary)
    assert_replicated(replicated_groups(state), "after the seeded init and the warm-start")
    train_step = build_train_step(config, layout)
    register_warmup = int(t.get("register_warmup_epochs", 0) or 0)
    warm_train_step = None
    if register_warmup > 0 and t.get("register", True):
        warm_cfg = copy.deepcopy(config)
        warm_cfg["training"]["register"] = False
        warm_train_step = build_train_step(warm_cfg, layout)
    eval_step = build_eval_step(state.hrnet)
    eval_batch = layout.eval_batch(t.get("eval_batch_size", 1))
    return RunPieces(state, train_step, warm_train_step, register_warmup, eval_step,
                     eval_batch, layout.synced and eval_batch > 1)
