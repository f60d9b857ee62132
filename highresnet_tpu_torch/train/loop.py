"""Training orchestration: train HRNet + ShiftNet and keep the best weights.

The counterpart of ``highresnet_tpu/train/loop.py``: per epoch, the train
steps (``epoch.py``), validation on pre-collated batches
(``evaluation.py``), EMA dual selection and best tracking
(``selection.py``), ReduceLROnPlateau on the raw val score, optional early
stop, and the full resumable state (``checkpoint.py``).

Across processes (``parallel/``; HRN_COORDINATOR or HRN_DISTRIBUTED=auto)
each replica trains on its shard of the train list at B / D scenes a step
(D the data size: the world, or ``training.mesh``'s ``data``, whose view
ranks split each replica's views), with the step's collectives making the
ranks' step the one-process step at batch B. Every rank computes the same
val scores, so selection, the plateau scheduler and early stop decide
alike; rank 0 names the run directory, writes the checkpoints and
TensorBoard and prints. The ranks are checked to hold identical state
after setup, after a resume, and at the end.

One difference from the JAX loop: a resumed run sets the train loader's
epoch counter to the epoch it resumes at, so it draws the same views and
patches as an uninterrupted run, and a 1 + 1 epoch run ends bit-identical
to a 2-epoch run (the JAX loop restarts the loader's sampling at epoch 0).
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from highresnet_tpu_torch.data import discover_scenes, read_baseline_cpsnr, train_val_split
from highresnet_tpu_torch.data.pipeline import EpochCache, shard_for_hosts
from highresnet_tpu_torch.parallel.distributed import (
    assert_replicated,
    broadcast_string,
    maybe_initialize,
)
from highresnet_tpu_torch.parallel.mesh import check_local_shard, setup_data_parallel
from highresnet_tpu_torch.runtime import resolve_device
from highresnet_tpu_torch.train.checkpoint import CheckpointManager, resume_run
from highresnet_tpu_torch.train.epoch import run_train_epoch, warn_warp_window
from highresnet_tpu_torch.train.evaluation import build_val_batches, evaluate_model
from highresnet_tpu_torch.train.schedule import ReduceLROnPlateau
from highresnet_tpu_torch.train.selection import BestTracker, dual_candidates, host_copy
from highresnet_tpu_torch.train.setup import (
    build_models_and_steps,
    build_train_loader,
    replicated_groups,
)
from highresnet_tpu_torch.train.tb import TBWriter
from highresnet_tpu_torch.utils.profiling import enable_nan_debugging


def _run_dir_name(t: Dict[str, Any]) -> str:
    stamp = f"{datetime.datetime.now():%Y-%m-%d-%H-%M-%S-%f}"
    return (
        f"batch_{t['batch_size']}_views_{t['n_views']}_min_{t['min_L']}"
        f"_beta_{t['beta']}_time_{stamp}"
    )


def train_and_get_best_model(
    config: Dict[str, Any],
    max_steps: Optional[int] = None,
    run_dir: Optional[str] = None,
    device: torch.device | str = "cuda",
) -> Dict[str, Any]:
    """Train HRNet + ShiftNet on ``device``; checkpoint and return the best.

    Returns {'params', 'batch_stats', 'best_score', 'best_epoch',
    'val_history', 'run_dir', 'train_loss'} (+ 'ema_selection' with EMA on);
    the weights are host (CPU) tensors, 'train_loss' is the last epoch's
    mean train loss (None when no epoch ran).
    """
    device = resolve_device(device)
    maybe_initialize(device)  # no-op unless HRN_COORDINATOR / HRN_DISTRIBUTED asks
    t = config["training"]
    paths = config["paths"]
    seed = t.get("seed", 123)
    layout = setup_data_parallel(t, device)
    if t.get("debug_nans", False):
        enable_nan_debugging(True)

    # --- data ---------------------------------------------------------------
    data_dir = paths["prefix"]
    baseline = None
    norm_path = os.path.join(data_dir, "norm.csv")
    if os.path.exists(norm_path):
        baseline = read_baseline_cpsnr(norm_path)
    scene_dirs = discover_scenes(os.path.join(data_dir, "train"))
    if not scene_dirs:
        raise FileNotFoundError(f"no scenes under {data_dir}/train/(RED|NIR)")
    train_list, val_list = train_val_split(scene_dirs, t["val_proportion"], seed=1)

    local_train_list = shard_for_hosts(train_list, layout.d, layout.data)
    check_local_shard(layout, len(local_train_list))
    loader = build_train_loader(t, local_train_list, seed=seed, data_dir=data_dir, layout=layout)
    pieces = build_models_and_steps(config, device, seed=seed, train_list=train_list,
                                    layout=layout)
    state, eval_step, eval_batch = pieces.state, pieces.eval_step, pieces.eval_batch

    # the val set is collated once with a seeded rng (deterministic score);
    # training.val_views = [k, ...] adds truncated-view batch lists and the
    # selection score is the mean over the full stack and each of them
    val_views = [int(v) for v in (t.get("val_views") or [])]
    val_batches = None
    if t.get("cache_val_batches", True) or val_views:
        val_batches = build_val_batches(
            val_list, t["min_L"], t["n_views"], t["beta"], eval_batch,
            rng=np.random.default_rng(seed + 10007),
        )
    extra_val_batches = [
        build_val_batches(
            val_list, t["min_L"], t["n_views"], t["beta"], eval_batch,
            rng=np.random.default_rng(seed + 10007), truncate_to=k,
        )
        for k in val_views
        if k < t["min_L"]
    ]

    def eval_params_hrnet(params_hrnet, sample_rng, return_images=False):
        def one(batches, want_images):
            return evaluate_model(
                params_hrnet, eval_step, val_list, t["min_L"], baseline,
                top_k=t["n_views"], beta=t["beta"], batch_size=eval_batch,
                return_images=want_images, prebuilt_batches=batches,
                sample_rng=sample_rng, device=device, shard=pieces.eval_shard,
                group=layout.data_group,
            )

        if not extra_val_batches:
            return one(val_batches, return_images)
        out = one(val_batches, return_images)  # full stack first (images)
        score, images = (out[0], out[1:]) if return_images else (out, ())
        mixture = float(np.mean([score] + [one(b, False) for b in extra_val_batches]))
        return (mixture, *images) if return_images else mixture

    if run_dir is None:  # rank 0's clock names it
        run_dir = broadcast_string(os.path.join(paths["checkpoint_dir"], _run_dir_name(t)))
    ckpt = CheckpointManager(run_dir)
    scheduler = ReduceLROnPlateau(t["lr"], factor=t["lr_decay"], patience=t["lr_step"])
    writer = TBWriter(paths.get("tb_log_file_dir"), os.path.basename(run_dir),
                      enabled=layout.primary)

    # --- resume -------------------------------------------------------------
    tracker = BestTracker(ckpt, patience=t.get("early_stop_patience", 0))
    tracker.seed(host_copy({"params": state.eval_params, "batch_stats": state.batch_stats}))
    state, start_epoch = resume_run(ckpt, state, tracker, scheduler)
    if start_epoch > 1:
        assert_replicated(replicated_groups(state), "after the resume")
    loader.epoch = start_epoch - 1  # the sampling an uninterrupted run would draw
    if isinstance(loader, EpochCache):  # and the variant it would build next
        loader.loader.epoch = start_epoch - 1

    steps_done = 0
    train_loss = None
    num_epochs = t["num_epochs"]
    warp_warn_from = 1
    for epoch in range(start_epoch, num_epochs + 1):
        warm = pieces.warm_train_step is not None and epoch <= pieces.register_warmup
        step_fn = pieces.warm_train_step if warm else pieces.train_step
        state, estats, n_steps = run_train_epoch(
            loader, state, step_fn, device,
            steps_left=None if max_steps is None else max_steps - steps_done,
            replicas=layout.data,
        )
        steps_done += n_steps
        train_loss = estats["train_loss"]
        t0 = time.time() - estats["seconds"]
        warp_warn_from = warn_warp_window(t, estats["max_abs_shift"], epoch, warp_warn_from)

        def epoch_val_rng():
            # cache_val_batches=false: re-sample views each epoch, from an
            # epoch-seeded rng so the raw and EMA candidates score one draw
            return None if val_batches is not None else np.random.default_rng((seed, 1000003, epoch))

        val_out = eval_params_hrnet(
            state.eval_params["hrnet"], epoch_val_rng(), return_images=writer.active
        )
        val_score, sr0, hr0 = val_out if writer.active else (val_out, None, None)

        cand_score, cand_params, raw_val_score, ema_val_score = dual_candidates(
            state, val_score, lambda p: eval_params_hrnet(p, epoch_val_rng())
        )
        if raw_val_score is not None:
            if ema_val_score <= raw_val_score:
                tracker.ema_wins += 1
            else:
                tracker.raw_wins += 1
        tracker.val_history.append((epoch, float(cand_score)))
        if tracker.update(epoch, cand_score, cand_params, state.batch_stats):
            if raw_val_score is not None:
                tracker.best_source = "ema" if cand_score == ema_val_score else "raw"

        val_score = cand_score
        # the plateau scheduler steps on the RAW score, so an EMA readout
        # never steers the raw trajectory
        new_lr = scheduler.step(raw_val_score if raw_val_score is not None else val_score)
        state = state.with_learning_rate(new_lr)
        early_stop = tracker.early_stop(epoch)

        every = t.get("checkpoint_every", 1)
        stopping = (
            epoch == num_epochs or early_stop or (max_steps is not None and steps_done >= max_steps)
        )
        if (every > 0 and epoch % every == 0) or stopping:
            ckpt.save_state(state, {
                "epoch": epoch,
                "best_score": tracker.best_score,
                "best_epoch": tracker.best_epoch,
                "scheduler": scheduler.state_dict(),
                "val_history": tracker.val_history,
            })

        writer.log_epoch(
            epoch,
            {
                "train/loss": estats["train_loss"],
                "train/val_loss": val_score,
                "train/val_loss_raw": raw_val_score,
                "train/val_loss_ema": ema_val_score,
                "train/lr": new_lr,
                "train/mean_abs_shift": estats["mean_abs_shift"],
                "train/max_abs_shift": estats["max_abs_shift"],
                "train/grad_norm": estats["grad_norm"],
            },
            sr0=sr0,
            hr0=hr0,
        )
        if layout.primary:
            print(
                f"epoch {epoch}/{num_epochs} loss={estats['train_loss']:.4f} "
                f"val={val_score:.4f} best={tracker.best_score:.4f} lr={new_lr:.2e} "
                f"({time.time() - t0:.1f}s)",
                flush=True,
            )
        if early_stop:
            if layout.primary:
                print(
                    f"early stop at epoch {epoch}: no val improvement since epoch "
                    f"{tracker.best_epoch} (patience {tracker.patience})",
                    flush=True,
                )
            break
        if max_steps is not None and steps_done >= max_steps:
            break

    writer.close()
    assert_replicated(replicated_groups(state), "at the end of the run")
    out = {
        "params": tracker.best["params"],
        "batch_stats": tracker.best["batch_stats"],
        "best_score": tracker.best_score,
        "best_epoch": tracker.best_epoch,
        "val_history": tracker.val_history,
        "run_dir": run_dir,
        "train_loss": train_loss,
    }
    if state.ema is not None:
        out["ema_selection"] = {
            "best_from": tracker.best_source,
            "epochs_ema_better": tracker.ema_wins,
            "epochs_raw_better": tracker.raw_wins,
        }
    return out
