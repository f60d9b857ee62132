"""Train HRNet + ShiftNet, TR-MISR + ShiftNet, or RAMS, for multi-frame super-resolution.

Usage:
    python -m highresnet_tpu_torch.cli.train --config configs/config.json \
        [--run-dir D] [--max-steps N] [--device cuda]

The same flags as ``highresnet_tpu.cli.train`` plus ``--device``: --run-dir
creates or resumes a run directory, --max-steps stops after N optimizer
steps. The run directory's ``best/HRNet.pth`` serves through
``highresnet_tpu_torch.cli.predict --checkpoint <run dir>``; under
``network.arch: "rams"`` (``configs/rams.json``) the run trains RAMS alone
with its cL1 loss and keeps ``best/RAMS.pth``; under ``network.arch:
"trmisr"`` (``configs/trmisr.json``) it trains TR-MISR with HRNet's
registered loss and keeps ``best/TRNet.pth`` beside ``best/ShiftNet.pth``.

Data parallelism runs one process per card, each on its shard of the
global batch ``training.batch_size`` (which the world size must divide):

    HRN_DISTRIBUTED=auto torchrun --nproc-per-node 4 \
        -m highresnet_tpu_torch.cli.train --config configs/config.json

(``--device cuda`` becomes ``cuda:$LOCAL_RANK``), or on bare metal one
process per rank with

    HRN_COORDINATOR=host0:29500 HRN_NUM_PROCESSES=4 HRN_PROCESS_ID=<i> \
        python -m highresnet_tpu_torch.cli.train --config ... --device cuda:<card>

NCCL joins the processes on cards, Gloo with ``--device cpu``. The run
directory must be on storage every process reads; rank 0 writes it.

The 2-D layout, ``"training": {"mesh": {"data": D, "view": M}}`` in the
config, runs on D·M processes launched the same way (``--nproc-per-node
D·M``): D replicas split the batch, and the M ranks of each replica split
its views (``parallel/mesh.py``).
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", default="configs/config.json", help="path of the config file")
    parser.add_argument("--run-dir", default=None, help="checkpoint dir to create/resume")
    parser.add_argument("--max-steps", type=int, default=None, help="stop after N optimizer steps")
    parser.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = parser.parse_args(argv)
    if not os.path.isfile(args.config):
        parser.error(f"config file not found: {args.config}")

    from highresnet_tpu_torch.config import load_config
    from highresnet_tpu_torch.parallel.distributed import process_index, shutdown
    from highresnet_tpu_torch.runtime import setup_device
    from highresnet_tpu_torch.train.loop import train_and_get_best_model

    config = load_config(args.config)
    device = setup_device(args.device)
    try:
        out = train_and_get_best_model(
            config, max_steps=args.max_steps, run_dir=args.run_dir, device=device
        )
    finally:
        shutdown()
    if process_index() == 0:
        print(f"best score: {out['best_score']:.4f}  (weights in {out['run_dir']})")
    return out


if __name__ == "__main__":
    main()
