"""Joint train state for the SR network + ShiftNet.

The counterpart of ``highresnet_tpu/train/state.py``: one Adam over both
models' parameters with a mutable learning rate (the plateau scheduler
lowers it between epochs), an optional global-norm gradient clip with
optax's semantics, the step count, the dropout generator, and an optional
EMA of the parameters started at init.

Where the JAX state is an immutable pytree replaced each step, this one
holds the models and updates them in place; ``with_learning_rate`` sets
the lr and returns the same state. On a card Adam is ``capturable``: its
lr is a device tensor that ``with_learning_rate`` writes in stream order
and its step counts live on the device, so the train step's CUDA graphs
(``train/graphs.py``) read every lr change. On the CPU the lr is a float.

The SR network is the one ``network.arch`` names (``models/network.py``),
kept under the name ``hrnet`` whichever it is. A network that comes without
ShiftNet (RAMS) trains alone: its state's ``shiftnet`` is None, and Adam,
the EMA and the checkpoint hold the network alone.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from torch import nn

from highresnet_tpu_torch.models.hrnet import HRNet
from highresnet_tpu_torch.models.network import build_network, with_shiftnet
from highresnet_tpu_torch.models.shiftnet import ShiftNet
from highresnet_tpu_torch.runtime import compute_dtypes

ADAM_BETAS = (0.9, 0.999)  # optax.adam's defaults
ADAM_EPS = 1e-8

Params = Dict[str, Dict[str, torch.Tensor]]  # {"hrnet": {name: tensor}[, "shiftnet": ...]}


def make_optimizer(params: List[torch.nn.Parameter], lr: float,
                   capturable: bool = False) -> torch.optim.Adam:
    """Adam with optax.adam's constants (b1 0.9, b2 0.999, eps 1e-8, eps_root 0);
    ``capturable``: the lr a float32 tensor on the parameters' device and
    the bias corrections computed there, so a CUDA graph may hold the update."""
    if capturable:
        lr = torch.tensor(float(lr), device=params[0].device)
    return torch.optim.Adam(params, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS, capturable=capturable)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(torch.square(t)) for t in tensors))


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float, norm: torch.Tensor) -> None:
    """optax.clip_by_global_norm in place: each gradient becomes
    (g / norm) * max_norm when norm >= max_norm and stays as it is otherwise.

    ``torch.nn.utils.clip_grad_norm_`` differs: it scales by
    max_norm / (norm + 1e-6). The choice is made on the device (no sync).
    """
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))


@dataclass
class TrainState:
    hrnet: HRNet  # the SR network: HRNet, RAMS or TR-MISR
    shiftnet: Optional[ShiftNet]  # None for RAMS
    optimizer: torch.optim.Adam
    generator: torch.Generator  # dropout masks, on the training device
    grad_clip_norm: float = 0.0
    step: int = 0
    ema: Optional[Params] = None  # training.ema_decay > 0: tracked copies

    @property
    def models(self) -> Dict[str, nn.Module]:
        """The trained models by name: ``hrnet`` and, where there is one, ``shiftnet``."""
        if self.shiftnet is None:
            return {"hrnet": self.hrnet}
        return {"hrnet": self.hrnet, "shiftnet": self.shiftnet}

    @property
    def params(self) -> Params:
        return {name: dict(model.named_parameters()) for name, model in self.models.items()}

    @property
    def eval_params(self) -> Params:
        """The weights validation and best-model selection score."""
        return self.params if self.ema is None else self.ema

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        """ShiftNet's BatchNorm buffers (running mean/var, batch counts)."""
        return {} if self.shiftnet is None else dict(self.shiftnet.named_buffers())

    @property
    def learning_rate(self) -> float:
        return float(self.optimizer.param_groups[0]["lr"])

    def with_learning_rate(self, lr: float) -> "TrainState":
        for group in self.optimizer.param_groups:
            if isinstance(group["lr"], torch.Tensor):  # capturable: the tensor a graph reads
                group["lr"].fill_(float(lr))
            else:
                group["lr"] = float(lr)
        return self

    def state_dict(self) -> Dict[str, Any]:
        """Everything a resumed run needs to continue bit for bit."""
        return {
            "hrnet": self.hrnet.state_dict(),
            "shiftnet": None if self.shiftnet is None else self.shiftnet.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "generator": self.generator.get_state(),
            "step": self.step,
            "ema": self.ema,
        }

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        if (sd["ema"] is None) != (self.ema is None):
            raise RuntimeError(
                "the checkpoint's EMA does not match training.ema_decay; resume with "
                "the original settings, or start a fresh run_dir"
            )
        if (sd["shiftnet"] is None) != (self.shiftnet is None):
            raise RuntimeError("the checkpoint's ShiftNet does not match network.arch")
        self.hrnet.load_state_dict(sd["hrnet"])
        if self.shiftnet is not None:
            self.shiftnet.load_state_dict(sd["shiftnet"])
        # the checkpoint's lr and capturable flag may come from a run on another
        # device: keep this optimizer's own (its lr tensor is what a graph reads)
        saved, own = sd["optimizer"], self.optimizer.param_groups
        self.optimizer.load_state_dict({**saved, "param_groups": [
            {**g, "capturable": mine["capturable"]} for g, mine in zip(saved["param_groups"], own)]})
        for group, mine in zip(self.optimizer.param_groups, own):
            group["lr"] = mine["lr"]
        self.with_learning_rate(saved["param_groups"][0]["lr"])
        self.generator.set_state(sd["generator"])
        self.step = int(sd["step"])
        if self.ema is not None:
            with torch.no_grad():
                for model, tensors in self.ema.items():
                    for name, t in tensors.items():
                        t.copy_(sd["ema"][model][name])


def create_train_state(
    config: Dict[str, Any], device: torch.device | str, generator: torch.Generator
) -> TrainState:
    """The models drawn from ``generator`` (CPU): the SR network, then
    ShiftNet where the network comes with it; the joint optimizer, the dropout
    generator on ``device`` (seeded from ``generator``), and the EMA."""
    t = config["training"]
    device = torch.device(device)
    hrnet = build_network(config, device, generator)
    shiftnet = None
    if with_shiftnet(config):
        shiftnet = ShiftNet(register_size=t.get("register_size", 128), device=device,
                            dtype=compute_dtypes(t.get("compute_dtype"))[0], generator=generator)
    params = [*hrnet.parameters(), *(shiftnet.parameters() if shiftnet is not None else ())]
    dropout_seed = int(torch.randint(2**62, (1,), generator=generator))
    state = TrainState(
        hrnet=hrnet,
        shiftnet=shiftnet,
        optimizer=make_optimizer(params, t["lr"], capturable=device.type == "cuda"),
        generator=torch.Generator(device=device).manual_seed(dropout_seed),
        grad_clip_norm=float(t.get("grad_clip_norm", 0.0) or 0.0),
    )
    if float(t.get("ema_decay", 0.0) or 0.0) > 0:  # started AT init, so no debiasing is needed
        state.ema = {name: {k: p.detach().clone() for k, p in tensors.items()}
                     for name, tensors in state.params.items()}
    return state
