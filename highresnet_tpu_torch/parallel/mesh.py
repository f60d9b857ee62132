"""The layout of a training run over its processes.

The counterpart of ``highresnet_tpu/parallel/mesh.py`` and of
``setup_mesh`` in ``highresnet_tpu/train/setup.py``. JAX lays one process's
devices out as a ``data x view`` mesh; the port drives one card per process,
so the layout is the process group itself:

- **1-D (data)**, the default: the ``world`` processes each hold one shard
  of the global batch (``training.batch_size``, which the world divides),
  parameters are replicated and gradients averaged
  (``distributed.reduce_gradients_``). ``training.mesh = {"data": world}``
  is the same layout.
- **2-D (data x view)**, ``training.mesh = {"data": D, "view": M}`` on
  ``world = D·M`` processes: rank ``r`` has data index ``d = r // M`` and
  view index ``v = r % M``. The ranks of one ``v`` form a data group, over
  which the batch is split; the ranks of one ``d`` form a view group, which
  hold the same ``batch_size / D`` scenes and split their views: each
  encodes L/M views and packs its block of each fusion round's pairs, and
  fusion gathers the views back (``models/hrnet.py::HRNet.shard_views``).
  For very large L this shards the folded (B·L) encoder batch further
  (SURVEY.md §2).

JAX's checks and their words carry over: data·view must not exceed the
processes (nor, here, fall short of them: a rank outside the layout has no
meaning), ``batch_size`` must divide over data and ``min_L`` over view, and
a meshed run drops ragged batches, even at ``{"data": 1, "view": 1}`` in one
process (``check_local_shard``). One divergence: JAX refuses
``training.mesh`` in a multi-host run ("a single-controller feature"); in
the port every multi-card run is multi-process, so the port accepts it.

``training.data_parallel`` in one process that sees several CUDA devices:
the JAX loop spreads the batch over them; the port drives one card per
process, so it says how to launch one process per card and runs on one.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch
import torch.distributed as dist

from highresnet_tpu_torch.parallel.distributed import (
    is_initialized,
    process_count,
    process_index,
)

LAUNCH_HINT = ("the port drives one card per process: for data parallelism over the {n} visible "
               "cards launch HRN_DISTRIBUTED=auto torchrun --nproc-per-node {n} -m "
               "highresnet_tpu_torch.cli.train (with training.mesh = {{\"data\": D, \"view\": M}}, "
               "D·M processes); this run uses {device} alone")


class DataParallel(NamedTuple):
    rank: int
    world: int
    synced: bool  # a process group is up: the step's collectives run (at world 1 too)
    local_batch: int  # batch_size / data: the scenes each rank's step takes
    view: int = 1  # ranks that split one replica's views (M)
    meshed: bool = False  # training.mesh is set: ragged batches are dropped
    data_group: Any = None  # the ranks of this view index (None: the whole run)
    view_group: Any = None  # the ranks of this data index (None: no view axis)

    @property
    def primary(self) -> bool:
        return self.rank == 0

    @property
    def data(self) -> int:
        """D: the replicas the global batch splits over."""
        return self.world // self.view

    @property
    def d(self) -> int:
        return self.rank // self.view

    @property
    def v(self) -> int:
        return self.rank % self.view

    @property
    def drop_last(self) -> bool:
        """Ragged batches would leave the ranks with different batch sizes."""
        return self.world > 1 or self.meshed

    def eval_batch(self, eval_batch_size: int) -> int:
        """``eval_batch_size`` rounded up to a multiple of the data size
        (eval runs over ``data`` only, as in JAX), so each replica scores an
        equal share; 1 stays 1 (every rank scores the whole val set, as the
        JAX loop's one-device eval does)."""
        if eval_batch_size <= 1:
            return eval_batch_size
        return -(-eval_batch_size // self.data) * self.data


def _groups(world: int, view: int, rank: int):
    """(data group, view group) of ``rank``: every rank creates every group,
    in the same order, as ``dist.new_group`` requires."""
    data_group = view_group = None
    for v in range(view):
        g = dist.new_group(list(range(v, world, view)))
        if rank % view == v:
            data_group = g
    for d in range(world // view):
        g = dist.new_group(list(range(d * view, (d + 1) * view)))
        if rank // view == d:
            view_group = g
    return data_group, view_group


def setup_data_parallel(t: Dict[str, Any], device: torch.device) -> DataParallel:
    """The layout of this process in the run, after the checks JAX makes."""
    world, rank = process_count(), process_index()
    mesh = t.get("mesh")
    if mesh:
        data, view = int(mesh.get("data", 1)), int(mesh.get("view", 1))
        if data * view > world:
            raise ValueError(
                f"training.mesh data*view = {data}*{view} exceeds the {world} processes "
                "of the run (one card each)"
            )
        if t["batch_size"] % data:
            raise ValueError(f"batch_size {t['batch_size']} must divide over data={data}")
        if t["min_L"] % view:
            raise ValueError(f"min_L {t['min_L']} must divide over view={view}")
        if data * view < world:
            raise ValueError(
                f"training.mesh data*view = {data}*{view} leaves ranks of the {world} "
                "processes outside the layout: launch data*view processes"
            )
    else:
        data, view = world, 1
        if t["batch_size"] % world:
            raise ValueError(
                f"multi-host training needs batch_size divisible by the "
                f"global device count ({t['batch_size']} % {world})"
            )
    if (not is_initialized() and t.get("data_parallel", True) and device.type == "cuda"
            and torch.cuda.device_count() > 1):
        print(LAUNCH_HINT.format(n=torch.cuda.device_count(), device=device), flush=True)
    groups = _groups(world, view, rank) if view > 1 else (None, None)
    return DataParallel(rank, world, is_initialized(), t["batch_size"] // data, view,
                        bool(mesh), *groups)


def check_local_shard(layout: DataParallel, n_local_scenes: int) -> None:
    """A multi-process or meshed run drops ragged batches: with fewer local
    scenes than one local batch no step would run (JAX's check)."""
    if layout.drop_last and n_local_scenes < layout.local_batch:
        raise ValueError(
            f"batch_size {layout.local_batch} exceeds the {n_local_scenes} "
            "local training scenes: a mesh-sharded run drops ragged batches, "
            "so no training would happen. Lower batch_size or add scenes."
        )
