"""Archive super-resolution: closed-loop batches through ``Model.forward``.

Set-up makes the cell's weights and a pool of ``pool`` batches of
``batch`` scenes (``views`` views of ``lr_size`` px, between ``min_views``
and ``views`` of them real) on the device from the seed, keeps the
batches in host memory, loads the weights through ``Model.set_params``
and warms up with two calls. A call hands the next batch, as host numpy,
to ``Model.forward`` (the single-checkpoint ``_Forward``: host to device,
HRNet, device to host) and keeps the SR it returns.

The check draws, from the seed, one served call of every pool batch and
holds its SR to the plain reference's forward on the same batch and
weights (``sr_gap``: the worst scene's max |SR - ref| over max |ref|).
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import compare, flops, synth, weights
from perfbench.reference.hrnet import HRNet as RefHRNet
from perfbench.reference.hrnet import param_spec
from perfbench.reference.ops import F32, TF32, Ops, no_tf32

E2E = {"archive_scenes_per_s": "scenes/s"}
TRACE_CALLS = 3
STAGE_CALLS = 3


def pack_bytes(batch: int, views: int, channels: int, size: int) -> float:
    """Bytes K1 must move in one forward: per fusion round each state of
    the 2·half paired views read once and each pair written once (f32)."""
    total, n = 0.0, views
    while n // 2 > 0:
        half = n // 2
        total += 2.0 * batch * 2 * half * channels * size * size * 4
        n = half
    return total


class Session:
    def __init__(self, cell, device: torch.device, seed: int, control: bool = False):
        p = cell.traffic
        self.cell, self.device, self.seed = cell, device, seed
        self.net = cell.config["network"]
        self.batch, self.views, self.size = p["batch"], p["views"], p["lr_size"]
        g = torch.Generator(device=device).manual_seed(seed)
        self.params = weights.make(param_spec(self.net), g, device)
        self.pool = []
        for _ in range(p["pool"]):
            lrs, alphas, _, _ = synth.scenes(g, self.batch, self.views, self.size, device,
                                             min_views=p["min_views"])
            self.pool.append((lrs.cpu().numpy(), alphas.cpu().numpy()))
        self.model = None
        if control:
            ref = RefHRNet(self.net, Ops(TF32))

            def forward(lrs, alphas):
                with torch.inference_mode():
                    return ref(self.params, torch.as_tensor(lrs, device=device),
                               torch.as_tensor(alphas, device=device)).cpu().numpy()
            self.forward = forward
        else:
            from highresnet_tpu_torch.config import load_config
            from highresnet_tpu_torch.eval.evaluator import Model

            self.model = Model(load_config(str(cell.config_path)), device)
            self.model.set_params(self.params)
            self.forward = self.model.forward
        for _ in range(2):
            self.forward(*self.pool[0])
        self.outputs = []  # (pool index, SR) of every call

    def call(self) -> int:
        j = len(self.outputs) % len(self.pool)
        self.outputs.append((j, self.forward(*self.pool[j])))
        return self.batch

    def e2e(self, items: int, seconds: float, latencies) -> dict:
        return {"archive_scenes_per_s": items / seconds}

    def context(self) -> dict:
        f = flops.hrnet_forward_flops(self.net, 1, self.views, self.size)
        channels = self.net["recursive"]["in_channels"]
        return {"flops_per_item": f, "conv_flops_per_item": f,
                "pack_bytes_per_item": pack_bytes(1, self.views, channels, self.size)}

    def trace(self) -> int:
        return sum(self.call() for _ in range(TRACE_CALLS))

    def after_trace(self) -> dict:
        """Device ms of the whole HRNet forward and of its fusion stage,
        from CUDA events that forward hooks record inside the real call."""
        if self.model is None or self.device.type != "cuda":
            return {}
        hrnet = self.model.hrnet
        marks = {"forward": [], "fuse": []}
        handles = []
        for name, module in (("forward", hrnet), ("fuse", hrnet.fuse)):
            def pre(_m, _a, name=name):
                marks[name].append([torch.cuda.Event(enable_timing=True),
                                    torch.cuda.Event(enable_timing=True)])
                marks[name][-1][0].record()

            def post(_m, _a, _o, name=name):
                marks[name][-1][1].record()
            handles += [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]
        try:
            for _ in range(STAGE_CALLS):
                self.call()
            torch.cuda.synchronize(self.device)
        finally:
            for h in handles:
                h.remove()
        return {"stages_ms": {k: sum(a.elapsed_time(b) for a, b in v) for k, v in marks.items()}}

    def release(self) -> None:
        self.model = self.forward = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """sr_gap over one served call of each pool batch, drawn from the seed."""
        rng = np.random.default_rng(self.seed)
        served = {}
        for j, sr in self.outputs:
            served.setdefault(j, []).append(sr)
        no_tf32()
        ref = RefHRNet(self.net, Ops(F32))
        gap = 0.0
        for j in sorted(served):
            sr = served[j][rng.integers(len(served[j]))]
            lrs, alphas = self.pool[j]
            with torch.inference_mode():
                want = ref(self.params, torch.as_tensor(lrs, device=self.device),
                           torch.as_tensor(alphas, device=self.device)).cpu().numpy()
            gap = max(gap, compare.image_gap(sr, want))
        return {"sr_gap": gap}
