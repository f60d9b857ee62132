"""Registered training: ``run_train_epoch`` over ``build_train_step``.

Set-up makes both networks' weights and a pool of ``pool`` collated
batches (the configuration's ``batch_size`` scenes of ``min_L`` views of
``patch_size`` px, every view real, with their 3x HR patches) on the
device from the seed and keeps the batches in host memory, as the epoch
cache would serve them. It builds the program's
train state (``create_train_state``), loads the weights into it, seeds its
dropout generator from the seed, and drives it through its first three
steps on pool batches 0, 1 and 2 through the window's own call and feed
(``run_train_epoch``). It keeps each step's loss, every leaf's norm of the
first gradient (Adam's first moment after one step over 1 - b1) and of the
change of the parameters after three. A call of the window then runs
``steps_per_call`` more steps on the next pool batches, cycling.

The check runs the plain reference's three steps from the same weights,
batches and dropout seed and compares ``loss_gap`` (the first step's
relative gap), ``grad_gap`` (the worst leaf's gap of first gradient norms
over the larger of its reference norm and the median leaf's) and
``change_gap`` (the median leaf's gap of change norms, so measured, over
the leaves whose reference gradient reaches a thousandth of the median
leaf's at some step). The later steps' losses and the worst leaf's change
are not compared: a nudge of the reference's weights by 1e-7 of
themselves moves them as far as the program does (PERF.md), as Adam's
first steps turn gradients within round-off of zero into steps of lr.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from perfbench import compare, flops, synth, weights
from perfbench.reference import hrnet as ref_hrnet
from perfbench.reference import shiftnet as ref_shiftnet
from perfbench.reference.ops import F32, TF32, Ops, no_tf32
from perfbench.reference.train import B1, Trainer

E2E = {"train_scenes_per_s": "scenes/s"}
CHECK_STEPS = 3
LOSS_STEPS = 1  # the steps whose loss is compared
TRACE_STEPS = 4


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    if not names:
        return {}
    norms = torch.stack([torch.linalg.vector_norm(tensors[k].float()) for k in names]).tolist()
    return dict(zip(names, norms))


class Session:
    def __init__(self, cell, device: torch.device, seed: int, control: bool = False):
        p, t = cell.traffic, cell.config["training"]
        self.cell, self.device, self.seed, self.control = cell, device, seed, control
        self.config = cell.config
        self.batch, self.views, self.patch = t["batch_size"], t["min_L"], t["patch_size"]
        self.register = t.get("register_size", 128)
        self.steps_per_call = p["steps_per_call"]
        g = torch.Generator(device=device).manual_seed(seed)
        self.params = {
            **weights.make(ref_hrnet.param_spec(cell.config["network"]), g, device, "hrnet."),
            **weights.make(ref_shiftnet.param_spec(self.register), g, device, "shiftnet."),
        }
        self.dropout_seed = int(torch.randint(2**62, (1,), generator=g, device=device))
        self.pool = []
        for i in range(p["pool"]):
            arrays = synth.scenes(g, self.batch, self.views, self.patch, device,
                                  min_views=self.views, hr_shift_sigma=p["hr_shift_sigma"])
            self.pool.append([a.cpu().numpy() for a in arrays])
        self.next = 0
        self.losses: List[float] = []
        if control:
            self._control_setup()
        else:
            self._program_setup()

    def _feed(self, n: int):
        from highresnet_tpu_torch.data.collate import Batch

        out = []
        for _ in range(n):
            lrs, alphas, hrs, maps = self.pool[self.next % len(self.pool)]
            out.append(Batch(lrs, alphas, hrs, maps, [f"scene{k}" for k in range(len(lrs))]))
            self.next += 1
        return out

    def _program_setup(self) -> None:
        from highresnet_tpu_torch.config import load_config
        from highresnet_tpu_torch.train.epoch import run_train_epoch
        from highresnet_tpu_torch.train.state import create_train_state
        from highresnet_tpu_torch.train.step import build_train_step

        self.run_train_epoch = run_train_epoch
        config = load_config(str(self.cell.config_path))
        state = create_train_state(config, self.device, torch.Generator().manual_seed(0))
        for prefix, model in (("hrnet.", state.hrnet), ("shiftnet.", state.shiftnet)):
            n = len(prefix)
            done = model.load_state_dict({k[n:]: v for k, v in self.params.items()
                                          if k.startswith(prefix)}, strict=False)
            if done.unexpected_keys or any(k.split(".")[-1] not in (
                    "running_mean", "running_var", "num_batches_tracked")
                    for k in done.missing_keys):
                raise RuntimeError(f"weights do not fit the program's {prefix[:-1]}: {done}")
        state.generator = torch.Generator(device=self.device).manual_seed(self.dropout_seed)
        self.state = state
        step = build_train_step(config)

        def recording(state, *batch):
            state, m = step(state, *batch)
            self.losses.append(m["loss"])
            return state, m
        names = {p: f"{prefix}{k}" for prefix, model in (("hrnet.", state.hrnet),
                                                         ("shiftnet.", state.shiftnet))
                 for k, p in model.named_parameters()}
        self.state, _, _ = run_train_epoch(self._feed(1), state, recording, self.device)
        moments = {names[p]: s["exp_avg"] / (1 - B1) for p, s in state.optimizer.state.items()}
        self.first_grad = leaf_norms(moments)
        del moments
        self.state, _, _ = run_train_epoch(self._feed(CHECK_STEPS - 1), self.state, recording,
                                           self.device)
        self.change = leaf_norms({names[p]: p.detach() - self.params[names[p]]
                                  for p in names})
        self.losses = [float(x) for x in self.losses[:CHECK_STEPS]]
        self.step = step

    def _control_setup(self) -> None:
        """The reference at TF32 in the program's place."""
        self.trainer = Trainer(self.config, self.params, self.dropout_seed, Ops(TF32))
        for _ in range(CHECK_STEPS):
            self.losses.append(self.trainer.step(*self._tensors(self._feed(1)[0])))
        self.first_grad = self.trainer.grad_norms[0]
        self.change = leaf_norms({k: self.trainer.params[k].detach() - v
                                  for k, v in self.params.items()})

    def _tensors(self, batch):
        return [torch.as_tensor(a, device=self.device)
                for a in (batch.lrs, batch.alphas, batch.hrs, batch.hr_maps)]

    def _steps(self, n: int) -> int:
        if self.control:
            for b in self._feed(n):
                self.trainer.step(*self._tensors(b))
        else:
            self.state, _, _ = self.run_train_epoch(self._feed(n), self.state, self.step,
                                                    self.device)
        return n * self.batch

    def call(self) -> int:
        return self._steps(self.steps_per_call)

    def trace(self) -> int:
        return self._steps(TRACE_STEPS)

    def e2e(self, items: int, seconds: float, latencies) -> dict:
        return {"train_scenes_per_s": items / seconds}

    def context(self) -> dict:
        f = flops.train_step_flops(self.config["network"], 1, self.views, self.patch,
                                   self.register)
        return {"flops_per_item": f,
                "conv_flops_per_item": f - 3 * flops.lanczos_warp_flops(1, 3 * self.patch)}

    def after_trace(self) -> dict:
        return {}

    def release(self) -> None:
        self.state = self.step = self.trainer = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        no_tf32()
        ref = Trainer(self.config, self.params, self.dropout_seed, Ops(F32))
        self.next = 0
        losses = [ref.step(*self._tensors(self._feed(1)[0])) for _ in range(CHECK_STEPS)]
        change = leaf_norms({k: ref.params[k].detach() - v for k, v in self.params.items()})
        moving = compare.moving_leaves(ref.grad_norms)
        return {
            "loss_gap": compare.loss_gap(self.losses[:LOSS_STEPS], losses[:LOSS_STEPS]),
            "grad_gap": float(compare.leaf_gaps(self.first_grad, ref.grad_norms[0]).max()),
            "change_gap": float(np.median(compare.leaf_gaps(self.change, change, moving))),
        }
