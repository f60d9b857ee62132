"""CUDA graphs of the train step.

On a card the host issues a train step as ~500 kernel launches, one at a
time, and a step whose kernels are short waits on them. ``build_train_step``
therefore captures its step as three CUDA graphs and replays them: the
gradient fill (zero-grad), the forward to the clip (forward, registration,
loss, backward, global norm and clip, the metrics) and the update (Adam,
then the EMA when on). The same kernels run in the same order on the same
tensors, so a replayed step computes what the eager step computes.

The policy, by what the step can observe:

- a step runs eagerly where it cannot be captured: off CUDA, and in a
  synced data-parallel step (its collectives run between the phases);
- a step's key is its inputs' shapes, dtypes and device, the mode its
  state sets (the clip, ShiftNet's dropout rate and TR-MISR's) and the identity of the
  dropout generator. The rest of the mode (the registered arm, the EMA,
  the range penalty) is fixed when the step function is built, and each
  step function keeps its own graphs;
- the first step of a key runs eagerly: the warm-up that sets up Adam's
  state, cuDNN's plans and workspaces and the border mask's cache. The
  second captures the key's graphs and then replays them, so that step
  runs through the graphs; every later step of the key replays. A step
  whose parameters lack a gradient or Adam's state runs eagerly whatever
  its key (a sighting all the same), so no lazy set-up is ever captured;
- at most ``KEYS`` keys hold graphs; once they do, a new key stays eager,
  so shapes that change from batch to batch (variable-L recipes) never
  capture over and over. The graphs of all keys share one memory pool: the
  graphs never run at once, and what one leaves in the pool (its metrics)
  is copied out right after its replay.

A replay copies the step's inputs into the graph's own input tensors in
stream order, launches the three graphs inside the spans that time them
(``train.step.zero_grad``, the caller's ``train.step``,
``train.step.optimizer``, each replay in a ``train.step.replay``) and
returns fresh copies of the metrics. The spans inside the forward
(``train.step.forward``, ``.register``, ``.loss``, ``.backward``,
``.clip``, the ``hrnet.*`` stages) open only while a step runs eagerly or
is captured (``train.step.capture``), not on a replay.

What a replay relies on:

- the captured tensors stay the live ones: the parameters, their
  gradients and the optimizer's state. ``TrainState.load_state_dict``
  replaces Adam's state, and the key's graphs are then dropped and the key
  starts again from its first sighting;
- the lr is a device tensor (``TrainState.with_learning_rate`` writes it)
  and Adam is ``capturable`` (``train/state.py``);
- the dropout generator is registered with the forward's graph, so each
  replay advances it as the eager step does and a resumed run redraws the
  same masks (ShiftNet's and, for TR-MISR, the SR network's);
- the kernels K1-K3 and K5 launch on the current stream, and each replay
  adds to ``ops.fusion.LAUNCHES``, ``ops.lanczos_fused.LAUNCHES`` and
  ``ops.attention.LAUNCHES`` the launches its capture counted (the capture
  itself counts none).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import torch

from highresnet_tpu_torch.ops import attention, fusion, lanczos_fused
from highresnet_tpu_torch.utils.profiling import span

EAGER, CAPTURE, REPLAY = "eager", "capture", "replay"
KEYS = 4  # keys that hold graphs
SEEN = 64  # keys remembered from their first sighting


def eligible(device: torch.device, synced: bool) -> bool:
    """Whether a step on ``device`` may be captured at all."""
    return device.type == "cuda" and not synced


def step_key(batch: Sequence[torch.Tensor], mode: Tuple, generator: torch.Generator) -> Tuple:
    """The key of a step: its inputs' shapes, dtypes and device, its mode,
    its dropout generator (equal only to itself; the key holds it, so no
    later generator takes its identity)."""
    return (tuple((tuple(t.shape), t.dtype, t.device) for t in batch), mode, generator)


def decide(eligible: bool, warm: bool, seen: bool, captured: bool, full: bool) -> str:
    """The way a step runs: eager where it cannot be captured or has lazy
    set-up to run (not ``warm``); a key's graphs replay; a key seen before
    captures unless ``KEYS`` keys hold graphs."""
    if not (eligible and warm):
        return EAGER
    if captured:
        return REPLAY
    if seen and not full:
        return CAPTURE
    return EAGER


def launch_counts() -> Tuple[int, int, int, int]:
    return (fusion.LAUNCHES["pack"], fusion.LAUNCHES["unpack"], lanczos_fused.LAUNCHES,
            attention.LAUNCHES)


def add_launches(counts: Sequence[int]) -> None:
    fusion.LAUNCHES["pack"] += counts[0]
    fusion.LAUNCHES["unpack"] += counts[1]
    lanczos_fused.LAUNCHES += counts[2]
    attention.LAUNCHES += counts[3]


@dataclass
class StepGraphs:
    """One key's three graphs, the tensors they read and write, and what
    they were captured against."""

    zero: torch.cuda.CUDAGraph
    forward: torch.cuda.CUDAGraph
    update: torch.cuda.CUDAGraph
    inputs: List[torch.Tensor]
    metrics: Dict[str, torch.Tensor]
    launches: Tuple[int, ...]
    bound: Tuple  # the objects captured by address

    def live(self, bound: Tuple) -> bool:
        return len(bound) == len(self.bound) and all(a is b for a, b in zip(bound, self.bound))

    def replay(self, batch: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
        with span("train.step.zero_grad"), span("train.step.replay"):
            self.zero.replay()
        for static, x in zip(self.inputs, batch):
            static.copy_(x)
        with span("train.step.replay"):
            self.forward.replay()
        with span("train.step.optimizer"), span("train.step.replay"):
            self.update.replay()
        add_launches(self.launches)
        return {k: v.clone() for k, v in self.metrics.items()}


def capture(zero: Callable[[], None], forward: Callable[..., Dict[str, torch.Tensor]],
            update: Callable[[], None], batch: Sequence[torch.Tensor],
            generator: torch.Generator, pool, bound: Tuple) -> StepGraphs:
    """Capture the three phases of one step on ``batch``'s shapes; nothing
    runs (replay the result to take the step)."""
    before = launch_counts()
    inputs = [x.clone() for x in batch]
    graphs = [torch.cuda.CUDAGraph() for _ in range(3)]
    graphs[1].register_generator_state(generator)
    with span("train.step.capture"), torch.cuda.graph(graphs[0], pool=pool):
        zero()
    with span("train.step.capture"), torch.cuda.graph(graphs[1], pool=pool):
        metrics = forward(*inputs)
    with span("train.step.capture"), torch.cuda.graph(graphs[2], pool=pool):
        update()
    after = launch_counts()
    launches = tuple(a - b for a, b in zip(after, before))
    add_launches([-n for n in launches])
    return StepGraphs(*graphs, inputs, metrics, launches, bound)


class GraphedStep:
    """The sightings and graphs of one step function's keys (module notes)."""

    def __init__(self, keys: int = KEYS, seen: int = SEEN):
        self.keys, self.seen_limit = keys, seen
        self.seen: "OrderedDict[Hashable, None]" = OrderedDict()
        self.graphs: Dict[Hashable, StepGraphs] = {}
        self.pool: Optional[Any] = None  # one memory pool for every key's graphs

    def action(self, key: Hashable, eligible: bool = True, warm: bool = True) -> str:
        way = decide(eligible, warm, key in self.seen, key in self.graphs,
                     len(self.graphs) >= self.keys)
        if way == CAPTURE:
            del self.seen[key]
        elif way == EAGER and eligible:
            self.seen[key] = None
            self.seen.move_to_end(key)
            while len(self.seen) > self.seen_limit:
                self.seen.popitem(last=False)
        return way

    def __call__(self, key: Hashable, warm: bool, bound: Tuple, batch: Sequence[torch.Tensor],
                 generator: torch.Generator, zero: Callable, forward: Callable,
                 update: Callable) -> Optional[Dict[str, torch.Tensor]]:
        """An eligible step's metrics through its graphs, or None where the
        caller runs the step eagerly. ``warm``: every parameter has its
        gradient and Adam's state. ``bound``: the objects the graphs would
        hold by address; where they changed, the key's graphs go and its
        next step is a first sighting."""
        graphs = self.graphs.get(key)
        if graphs is not None and not graphs.live(bound):
            del self.graphs[key]
        way = self.action(key, warm=warm)
        if way == EAGER:
            return None
        if way == CAPTURE:
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            self.graphs[key] = capture(zero, forward, update, batch, generator, self.pool, bound)
        return self.graphs[key].replay(batch)
