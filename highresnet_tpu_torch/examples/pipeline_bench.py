"""Host input-pipeline throughput: live PNG vs packed vs epoch cache.

Measures what the host can FEED the card, across the three input paths of
the port's ``data/``:

  png    — live loader over per-view PNG decodes (reference-style)
  packed — live loader over the decode-free pack cache (data/pack.py)
  cache  — EpochCache mmap replay of pre-collated batches

    python -m highresnet_tpu_torch.examples.pipeline_bench [--scenes 64] [--views 16] \
        [--lr-size 128] [--out build/examples/PIPELINE_BENCH.json]

Pure host benchmark: no device. Its scenes/s are host numbers and stand
beside the host's core count (``protocol.host_cores``).
"""

from __future__ import annotations

import argparse
import os
import shutil
import time


def run(loader, epochs: int):
    n = 0
    t0 = time.perf_counter()
    for _ in range(epochs):
        for batch in loader:
            n += batch.lrs.shape[0]
            # touch the data the way a device copy would (forces mmap reads)
            float(batch.lrs[0, 0, 0, 0])
    dt = time.perf_counter() - t0
    return n / dt, dt


def main(argv=None):
    from highresnet_tpu_torch.exp.harness import default_out, default_root

    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=default_root("hrn_pipe_bench"))
    ap.add_argument("--scenes", type=int, default=64)
    ap.add_argument("--views", type=int, default=16)
    ap.add_argument("--lr-size", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--patch", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--out", default=default_out("PIPELINE_BENCH.json"))
    args = ap.parse_args(argv)

    from highresnet_tpu_torch.cli.pack_dataset import main as pack_main
    from highresnet_tpu_torch.data.pipeline import BatchLoader, EpochCache
    from highresnet_tpu_torch.data.probav import discover_scenes
    from highresnet_tpu_torch.data.synth import (
        clear_synthetic_dataset,
        make_synthetic_dataset,
        synthetic_dataset_complete,
    )
    from highresnet_tpu_torch.exp import harness

    if not synthetic_dataset_complete(args.root):
        clear_synthetic_dataset(args.root)
        make_synthetic_dataset(
            args.root,
            n_scenes_per_channel=args.scenes // 2,
            n_views=args.views,
            lr_size=args.lr_size,
            seed=0,
            splits=("train",),
        )
    scenes = discover_scenes(os.path.join(args.root, "train"))

    def mk_loader():
        return BatchLoader(
            scenes, batch_size=args.batch, min_l=args.views, top_k=args.views,
            beta=50.0, create_patches=True, patch_size=args.patch,
            seed=0, num_workers=args.workers,
        )

    results = {}

    png_rate, _ = run(mk_loader(), args.epochs)
    results["png_scenes_per_sec"] = round(png_rate, 1)

    t0 = time.perf_counter()
    pack_main(["--prefix", args.root])
    results["pack_build_seconds"] = round(time.perf_counter() - t0, 1)
    packed_rate, _ = run(mk_loader(), args.epochs)
    results["packed_scenes_per_sec"] = round(packed_rate, 1)

    cache_dir = os.path.join(args.root, ".bench_epoch_cache")
    shutil.rmtree(cache_dir, ignore_errors=True)
    cache = EpochCache(mk_loader(), cache_dir, n_variants=1)
    t0 = time.perf_counter()
    for _ in cache:  # build epoch (costs one live epoch)
        pass
    results["cache_build_seconds"] = round(time.perf_counter() - t0, 1)
    cache_rate, _ = run(cache, args.epochs)
    results["cache_scenes_per_sec"] = round(cache_rate, 1)

    results["protocol"] = {
        "scenes": len(scenes), "views": args.views, "lr_size": args.lr_size,
        "batch": args.batch, "patch": args.patch, "epochs_timed": args.epochs,
        "workers": args.workers, "host_cores": os.cpu_count(),
    }
    results["speedup_cache_vs_packed"] = round(cache_rate / packed_rate, 1)
    harness.emit_report(args.out, results)
    return results


if __name__ == "__main__":
    main()
