"""A forward at the model's full width, and a dry run across processes.

The counterpart of ``__graft_entry__.py``:

- ``entry(device)`` returns ``(fn, example_args)``: ``fn(params, lrs,
  alphas)`` is HRNet's forward at DEFAULT_CONFIG's width on a batch of 2
  scenes of 16 views at 64 px, on the card unless asked for the CPU.
- ``dryrun_multichip(n)`` runs inside each rank of an n-process group: one
  train step of a tiny config on the 2-D layout (data n/2, view 2) for even
  n >= 4, else on the 1-D data layout; then (a) the eval sharded over
  ``data``, (b) a checkpoint save and restore through
  ``train/checkpoint.py`` and one more step, and (c) one epoch of the
  variable-L loader (``variable_views_p`` 1) on that layout. JAX's
  host-sharded-array feed leg has no counterpart: each process feeds plain
  tensors.

    python -m highresnet_tpu_torch.dryrun N [--device cuda|cpu]

starts the N ranks on this host (a ``file://`` store in a temporary
directory, no port): Gloo with ``--device cpu``; on cards, rank r takes
``cuda:(r % cards)``, NCCL when every rank has a card of its own, Gloo when
ranks share one (NCCL refuses that). The pair pack stays on: each rank packs
a local tensor (JAX pins its XLA pack under a mesh, which SPMD cannot
partition a Pallas call over).
"""

from __future__ import annotations

import argparse
import copy
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Tuple

import numpy as np
import torch

TINY = {
    "network": {
        "encoder": {"in_channels": 2, "num_layers": 1, "kernel_size": 3, "channel_size": 8},
        "recursive": {"alpha_residual": True, "in_channels": 8, "kernel_size": 3},
        "decoder": {
            "deconv": {"in_channels": 8, "kernel_size": 3, "stride": 3, "out_channels": 8},
            "final": {"in_channels": 8, "kernel_size": 1, "out_channels": 1},
        },
    },
    "training": {
        "min_L": 4, "n_views": 4, "crop": 1, "lr": 1e-3, "lambda": 1e-6, "beta": 50.0,
        "patch_size": 16, "register_size": 32,
    },
}
TIMEOUT_S = 300  # each rank; a rank that dies fails the others within it


def entry(device: str | torch.device = "cuda") -> Tuple:
    """HRNet's forward at DEFAULT_CONFIG's width: (fn, (params, lrs, alphas)),
    ``fn(params, lrs, alphas) -> (B, 3H, 3W)`` SR."""
    from highresnet_tpu_torch.config import DEFAULT_CONFIG
    from highresnet_tpu_torch.models.hrnet import HRNet
    from highresnet_tpu_torch.runtime import resolve_device

    device = resolve_device(device)
    hrnet = HRNet(DEFAULT_CONFIG["network"], device=device).eval()
    b, l, p = 2, 16, 64
    rng = np.random.default_rng(0)
    lrs = torch.from_numpy(rng.random((b, l, p, p), dtype=np.float32)).to(device)
    alphas = torch.ones((b, l), device=device)

    def fn(params, lrs, alphas):
        with torch.inference_mode():
            return torch.func.functional_call(hrnet, params, (lrs, alphas))

    return fn, (dict(hrnet.state_dict()), lrs, alphas)


def _say(layout, text: str) -> None:
    if layout.primary:
        print(text, flush=True)


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda") -> None:
    """One step of the tiny config on the n-process layout, then the eval,
    checkpoint and variable-L loader legs; raises on a failed check."""
    from highresnet_tpu_torch.data import discover_scenes, make_synthetic_dataset
    from highresnet_tpu_torch.data.pipeline import shard_for_hosts
    from highresnet_tpu_torch.parallel.distributed import (
        assert_replicated,
        barrier,
        broadcast_string,
        process_count,
    )
    from highresnet_tpu_torch.parallel.mesh import setup_data_parallel
    from highresnet_tpu_torch.train.checkpoint import CheckpointManager
    from highresnet_tpu_torch.train.epoch import run_train_epoch
    from highresnet_tpu_torch.train.evaluation import evaluate_model
    from highresnet_tpu_torch.train.setup import build_train_loader, replicated_groups
    from highresnet_tpu_torch.train.state import create_train_state
    from highresnet_tpu_torch.train.step import build_eval_step, build_train_step

    if process_count() != n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) runs in a group of {n_devices} "
                           f"processes, this one has {process_count()}")
    device = torch.device(device)
    config = copy.deepcopy(TINY)
    t = config["training"]
    t["batch_size"] = 2 * n_devices
    use_2d = n_devices >= 4 and n_devices % 2 == 0
    if use_2d:
        t["mesh"] = {"data": n_devices // 2, "view": 2}
        name = f"2D layout (data={n_devices // 2}, view=2)"
    else:
        name = f"1D data layout ({n_devices})"
    layout = setup_data_parallel(t, device)
    state = create_train_state(config, device, torch.Generator().manual_seed(0))
    train_step = build_train_step(config, layout)

    b, l, p = t["batch_size"], t["min_L"], t["patch_size"]
    rng = np.random.default_rng(0)
    batch = (
        rng.random((b, l, p, p)).astype(np.float32),
        np.ones((b, l), np.float32),
        rng.random((b, 3 * p, 3 * p)).astype(np.float32),
        np.ones((b, 3 * p, 3 * p), np.float32),
    )
    rows = slice(layout.d * layout.local_batch, (layout.d + 1) * layout.local_batch)
    local = [torch.from_numpy(a[rows]).to(device) for a in batch]
    state, metrics = train_step(state, *local)
    loss_1 = metrics["loss"].item()
    if not np.isfinite(loss_1):
        raise AssertionError(f"dryrun_multichip({n_devices}) [{name}]: loss {loss_1}")
    assert_replicated(replicated_groups(state), "after one step")
    _say(layout, f"dryrun_multichip({n_devices}) [{name}]: loss={loss_1:.4f} OK")

    # (a) the eval sharded over 'data' (train/loop.py's path): every replica
    # scores its rows, all-gathered over the data group
    hrs_full = rng.random((b, 3 * p, 3 * p)).astype(np.float32)
    names = [f"scene{i}" for i in range(b)]
    score = evaluate_model(
        state.eval_params["hrnet"], build_eval_step(state.hrnet), None, l, None, top_k=l,
        beta=t["beta"], batch_size=b, prebuilt_batches=[(names, (batch[0], batch[1], hrs_full,
                                                                  batch[3]))],
        device=device, shard=layout.synced, group=layout.data_group,
    )
    if not np.isfinite(score):
        raise AssertionError(f"dryrun_multichip({n_devices}) [sharded eval]: score {score}")
    _say(layout, f"dryrun_multichip({n_devices}) [sharded eval, batch {b} over 'data']: "
                 f"mean shift_cPSNR={-score:.2f} OK")

    # (b) the full train state out through the checkpoint and back into a
    # fresh state, then one more step (the relaunch-resume path)
    ckpt_dir = broadcast_string(tempfile.mkdtemp(prefix="dryrun_ckpt_") if layout.primary else "")
    try:
        ckpt = CheckpointManager(ckpt_dir)
        ckpt.save_state(state, {"epoch": 1, "best_score": loss_1})
        restored = create_train_state(config, device, torch.Generator().manual_seed(1))
        meta = ckpt.restore_state(restored)
        if meta is None or meta.get("epoch") != 1:
            raise AssertionError(f"dryrun_multichip({n_devices}) [ckpt]: restored {meta}")
        assert_replicated(replicated_groups(restored), "after the restore")
        restored, m_resume = train_step(restored, *local)
        if not np.isfinite(m_resume["loss"].item()):
            raise AssertionError(f"dryrun_multichip({n_devices}) [ckpt]: next-step loss")
        _say(layout, f"dryrun_multichip({n_devices}) [ckpt round-trip on {name}]: restored "
                     f"epoch 1, next-step loss={m_resume['loss'].item():.4f} OK")
    finally:
        barrier()
        if layout.primary:
            shutil.rmtree(ckpt_dir, ignore_errors=True)

    # (c) the real loader with per-scene view-count truncation
    # (variable_views_p 1): alpha-padded batches of min_L views on the layout
    data_dir = broadcast_string(tempfile.mkdtemp(prefix="dryrun_data_") if layout.primary else "")
    try:
        if layout.primary:
            make_synthetic_dataset(data_dir, n_scenes_per_channel=b // 2, n_views=l, lr_size=p,
                                   seed=0, splits=("train",), write_norm_csv=False)
        barrier()
        tv = dict(t, variable_views_p=1.0, shuffle=False, n_workers=1)
        scenes = shard_for_hosts(discover_scenes(os.path.join(data_dir, "train")), layout.d,
                                 layout.data)
        loader = build_train_loader(tv, scenes, seed=0, data_dir=data_dir, layout=layout)
        state, stats, n_steps = run_train_epoch(loader, state, train_step, device,
                                                replicas=layout.data)
        if n_steps < 1 or not np.isfinite(stats["train_loss"]):
            raise AssertionError(f"dryrun_multichip({n_devices}) [variable-L]: {n_steps} steps, "
                                 f"loss {stats['train_loss']}")
        assert_replicated(replicated_groups(state), "after the variable-L epoch")
        _say(layout, f"dryrun_multichip({n_devices}) [variable-L loader -> {name}]: "
                     f"{n_steps} step(s), loss={stats['train_loss']:.4f} OK")
    finally:
        barrier()
        if layout.primary:
            shutil.rmtree(data_dir, ignore_errors=True)


def _rank_main(rank: int, world: int, store: str, device: str) -> None:
    import datetime

    import torch.distributed as dist

    if device == "cuda":
        cards = torch.cuda.device_count()
        device = f"cuda:{rank % cards}"
        backend = "nccl" if cards >= world else "gloo"
        torch.cuda.set_device(device)
    else:
        backend = "gloo"
    from highresnet_tpu_torch.runtime import setup_device

    device = setup_device(device)
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        dryrun_multichip(world, device)
    finally:
        dist.destroy_process_group()


def launch(n: int, device: str) -> int:
    """Start the n ranks, wait for them (under TIMEOUT_S), kill the rest when
    one fails; returns the first non-zero exit code, or 0."""
    tmp = tempfile.mkdtemp(prefix="dryrun_store_")
    env = dict(os.environ, OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 1) // n)))
    procs = [subprocess.Popen([sys.executable, "-m", "highresnet_tpu_torch.dryrun", str(n),
                               "--device", device, "--rank", str(r), "--store",
                               os.path.join(tmp, "store")], env=env)
             for r in range(n)]
    try:
        deadline = time.monotonic() + TIMEOUT_S
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return next((p.returncode for p in procs if p.returncode), 0)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("n", type=int, help="processes (ranks) of the dry run")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank is not None:
        _rank_main(args.rank, args.n, args.store, args.device)
        return 0
    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("CUDA is not available; pass --device cpu")
    return launch(args.n, args.device)


if __name__ == "__main__":
    sys.exit(main())
