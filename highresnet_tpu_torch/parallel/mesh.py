"""The data-parallel layout of a training run.

The counterpart of ``highresnet_tpu/parallel/mesh.py`` and of
``setup_mesh`` in ``highresnet_tpu/train/setup.py``. The port has one axis,
``data``: the processes of the group, one device each. The global batch
(``training.batch_size``) splits evenly over them, parameters are
replicated, and gradients are averaged (``distributed.reduce_gradients_``).

- ``training.mesh`` (an explicit 2-D data x view layout) is refused: with
  JAX's ``ValueError`` in a multi-process run, as JAX refuses it there, and
  with ``NotImplementedError`` in one process (the view axis is not ported).
- ``training.data_parallel`` in one process that sees several CUDA devices:
  the JAX loop spreads the batch over them; the port drives one card per
  process, so it says how to launch one process per card and runs on one.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from highresnet_tpu_torch.parallel.distributed import (
    is_initialized,
    process_count,
    process_index,
)

VIEW_AXIS = ("training.mesh (the 2-D data x view layout) is not ported yet (ROADMAP queue 1: "
             "the view axis); data parallelism runs one process per card, launched with "
             "torchrun and HRN_DISTRIBUTED=auto or with HRN_COORDINATOR")
LAUNCH_HINT = ("the port drives one card per process: for data parallelism over the {n} visible "
               "cards launch HRN_DISTRIBUTED=auto torchrun --nproc-per-node {n} -m "
               "highresnet_tpu_torch.cli.train; this run uses {device} alone")


class DataParallel(NamedTuple):
    rank: int
    world: int
    synced: bool  # a process group is up: the step's collectives run (at world 1 too)
    local_batch: int

    @property
    def primary(self) -> bool:
        return self.rank == 0

    @property
    def drop_last(self) -> bool:
        """Ragged batches would leave the ranks with different batch sizes."""
        return self.world > 1

    def eval_batch(self, eval_batch_size: int) -> int:
        """``eval_batch_size`` rounded up to a multiple of the world size, so
        each rank scores an equal share; 1 stays 1 (every rank scores the
        whole val set, as the JAX loop's one-device eval does)."""
        if eval_batch_size <= 1:
            return eval_batch_size
        return -(-eval_batch_size // self.world) * self.world


def setup_data_parallel(t: Dict[str, Any], device: torch.device) -> DataParallel:
    """The layout of this process in the run, after the checks JAX makes."""
    world, rank = process_count(), process_index()
    if t.get("mesh") and world > 1:
        raise ValueError(
            "training.mesh (explicit 2-D layout) is a single-controller "
            "feature; multi-host runs use the 1-D per-host data layout"
        )
    if t.get("mesh"):
        raise NotImplementedError(VIEW_AXIS)
    if t["batch_size"] % world:
        raise ValueError(
            f"multi-host training needs batch_size divisible by the "
            f"global device count ({t['batch_size']} % {world})"
        )
    if (not is_initialized() and t.get("data_parallel", True) and device.type == "cuda"
            and torch.cuda.device_count() > 1):
        print(LAUNCH_HINT.format(n=torch.cuda.device_count(), device=device), flush=True)
    return DataParallel(rank, world, is_initialized(), t["batch_size"] // world)


def check_local_shard(layout: DataParallel, n_local_scenes: int) -> None:
    """A multi-process run drops ragged batches: with fewer local scenes
    than one local batch no step would run (JAX's check)."""
    if layout.drop_last and n_local_scenes < layout.local_batch:
        raise ValueError(
            f"batch_size {layout.local_batch} exceeds the {n_local_scenes} "
            "local training scenes: a mesh-sharded run drops ragged batches, "
            "so no training would happen. Lower batch_size or add scenes."
        )
