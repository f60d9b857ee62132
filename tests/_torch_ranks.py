"""One rank of the port's multi-process CPU tests (Gloo, ``file://`` store).

    python tests/_torch_ranks.py <mode> <rank> <world> <store> <in> <out>

Each child joins the group through a ``file://`` store under the test's
tmp_path (no TCP port, so parallel test workers never collide), runs one
piece of the port on its shard and writes what it computed to ``<out>``
(``torch.save``). Modes:

- ``bn``: the synced ``BatchNorm2d`` in train mode on this rank's rows;
- ``step``: one ``build_train_step(config, layout)`` step on the layout of
  the config (its ``training.mesh``, else one data axis over the world),
  each rank on its replica's rows (all views);
- ``loop``: ``train_and_get_best_model`` on the config in ``<in>``.

``run_loop`` is also the one-process oracle the tests run in their own
process. Nothing here imports JAX.
"""

from __future__ import annotations

import datetime
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TIMEOUT = datetime.timedelta(seconds=90)  # a rank that dies fails the other within it


def rows(x, rank: int, world: int):
    n = x.shape[0] // world
    return x[rank * n:(rank + 1) * n]


def run_bn(inp: dict, rank: int, world: int) -> dict:
    from highresnet_tpu_torch.models.layers import BatchNorm2d

    bn = BatchNorm2d(inp["x"].shape[1])
    bn.load_state_dict(inp["state"])
    bn.synced = True
    x = rows(inp["x"], rank, world).clone().requires_grad_(True)
    y = bn(x)
    (y * rows(inp["g"], rank, world)).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dw": bn.weight.grad, "db": bn.bias.grad,
            "buffers": {k: v.clone() for k, v in bn.named_buffers()}}


def port_state(inp: dict):
    """The train state of ``inp``: the config's seeded state, then the saved
    weights, dropout rate and generator state."""
    from highresnet_tpu_torch.train.state import create_train_state

    state = create_train_state(inp["config"], "cpu", torch.Generator().manual_seed(0))
    state.hrnet.load_state_dict(inp["hrnet"])
    state.shiftnet.load_state_dict(inp["shiftnet"])
    state.shiftnet.dropout = inp["dropout"]
    state.generator.set_state(inp["generator"])
    return state


def step_result(state, metrics) -> dict:
    return {
        "metrics": {k: v.item() for k, v in metrics.items()},
        "grads": {f"{name}.{k}": p.grad.clone() for name in ("hrnet", "shiftnet")
                  for k, p in getattr(state, name).named_parameters()},
        "params": {f"{name}.{k}": v.clone() for name in ("hrnet", "shiftnet")
                   for k, v in getattr(state, name).state_dict().items()},
        "generator": state.generator.get_state(),
    }


def run_step(inp: dict, rank: int, world: int) -> dict:
    """One step; ``packs`` lists the views of each pair pack the forward made."""
    from highresnet_tpu_torch.models import hrnet
    from highresnet_tpu_torch.parallel.mesh import setup_data_parallel
    from highresnet_tpu_torch.train.step import build_train_step

    layout = setup_data_parallel(inp["config"]["training"], torch.device("cpu"))
    state = port_state(inp)
    step = build_train_step(inp["config"], layout)
    args = [rows(torch.from_numpy(a), layout.d, layout.data) for a in inp["batch"]]
    packs, real = [], hrnet.pack_pairs
    hrnet.pack_pairs = lambda x: (packs.append(x.shape[1]), real(x))[1]
    try:
        state, metrics = step(state, *args)
    finally:
        hrnet.pack_pairs = real
    return {**step_result(state, metrics), "packs": packs}


def run_loop(config: dict, run_dir: str) -> dict:
    """``train_and_get_best_model`` with its steps, epochs, final state and
    file writes recorded: per-step and per-epoch train loss, val history,
    best score, one checksum per model of the final state, and the files this
    process wrote."""
    from highresnet_tpu_torch.parallel import distributed
    from highresnet_tpu_torch.train import checkpoint, loop, setup

    steps, epochs, states, writes = [], [], [], []
    real = loop.run_train_epoch, checkpoint._atomic, setup.build_train_step
    real_epoch, real_atomic, real_build = real

    def epoch(loader, state, *args, **kwargs):
        state, stats, n = real_epoch(loader, state, *args, **kwargs)
        epochs.append(stats)
        states.append(state)
        return state, stats, n

    def atomic(path, write):
        writes.append(path)
        return real_atomic(path, write)

    def build(*args, **kwargs):
        step = real_build(*args, **kwargs)

        def recorded(state, *batch):
            state, metrics = step(state, *batch)
            steps.append(metrics["loss"].item())
            return state, metrics

        return recorded

    loop.run_train_epoch, checkpoint._atomic, setup.build_train_step = epoch, atomic, build
    try:
        out = loop.train_and_get_best_model(config, run_dir=run_dir, device="cpu")
    finally:
        loop.run_train_epoch, checkpoint._atomic, setup.build_train_step = real
    final = states[-1]
    return {
        "rank": distributed.process_index(),
        "world": distributed.process_count(),
        "step_losses": steps,
        "losses": [e["train_loss"] for e in epochs],
        "grad_norms": [e["grad_norm"] for e in epochs],
        "vals": [s for _, s in out["val_history"]],
        "best_score": out["best_score"],
        "checksums": {name: distributed.checksum(getattr(final, name).state_dict().values())
                      for name in ("hrnet", "shiftnet")},
        "writes": writes,
        "run_dir": out["run_dir"],
    }


CHILD_TIMEOUT_S = 120


def launch(mode: str, inp: dict, tmp_path, world: int = 2, tag: str = "") -> list:
    """Run the ``world`` ranks of one job; returns their outputs."""
    return launch_jobs([(mode, inp, tag)], tmp_path, world)[0]


def launch_jobs(jobs: list, tmp_path, world: int = 2) -> list:
    """Start the ranks of every (mode, inp, tag[, world]) job together, each
    job its own group of its own world (``world`` where the job names none);
    wait under CHILD_TIMEOUT_S, killing every child when one fails. Returns
    each job's rank outputs."""
    import subprocess

    tmp_path = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if not k.startswith("HRN_")}
    runs = []  # (job index, rank, out, log)
    procs = []
    try:
        for j, (mode, inp, tag, *job_world) in enumerate(jobs):
            name = os.path.join(tmp_path, f"{mode}{tag}")
            torch.save(inp, f"{name}_in.pt")
            n = job_world[0] if job_world else world
            env["OMP_NUM_THREADS"] = "2" if n <= 2 else "1"  # tests run beside other workers
            for r in range(n):
                out, log = f"{name}_out{r}.pt", f"{name}_log{r}.txt"
                with open(log, "w") as f:
                    procs.append(subprocess.Popen(
                        [sys.executable, os.path.abspath(__file__), mode, str(r), str(n),
                         f"{name}_store", f"{name}_in.pt", out],
                        env=env, stdout=f, stderr=subprocess.STDOUT))
                runs.append((j, r, out, log))
        deadline = time.monotonic() + CHILD_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    results = [[] for _ in jobs]
    for p, (j, r, out, log) in zip(procs, runs):
        if p.returncode != 0:
            with open(log) as f:
                raise AssertionError(f"rank {r} of {jobs[j][0]}{jobs[j][2]} exited "
                                     f"{p.returncode}:\n{f.read()[-4000:]}")
        results[j].append(torch.load(out, weights_only=False))
    return results


def main(mode: str, rank: int, world: int, store: str, in_path: str, out_path: str) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=TIMEOUT)
    inp = torch.load(in_path, weights_only=False)
    if mode == "bn":
        out = run_bn(inp, rank, world)
    elif mode == "step":
        out = run_step(inp, rank, world)
    else:
        out = run_loop(inp["config"], inp["run_dir"])
    torch.save(out, out_path)
    dist.destroy_process_group()


if __name__ == "__main__":
    mode, rank, world, store, in_path, out_path = sys.argv[1:7]
    main(mode, int(rank), int(world), store, in_path, out_path)
