"""The train step through CUDA graphs (``train/graphs.py``).

On the CPU: the policy that decides how a step runs (eager, capture,
replay) and the key it goes by, the lr that ``with_learning_rate`` hands
the step, and the step's metrics staying its own. On a card (skipped
without one): replayed steps against eager steps bit for bit, at the
benchmark's two configurations cut to small widths, with an lr change, a
shape change and dropout on, and a resume mid-run.

This file imports neither JAX nor the JAX package, so it runs on a GPU
machine without JAX:

    python -m pytest tests/test_torch_train_graph.py --noconftest -q
"""

import copy
import json
from pathlib import Path

import pytest
import torch

from highresnet_tpu_torch.train import graphs
from highresnet_tpu_torch.train import step as step_module
from highresnet_tpu_torch.train.graphs import CAPTURE, EAGER, KEYS, REPLAY, SEEN
from highresnet_tpu_torch.train.state import TrainState, create_train_state, make_optimizer
from highresnet_tpu_torch.train.step import build_train_step

ROOT = Path(__file__).resolve().parents[1]
SMALL_NETWORK = {
    "encoder": {"in_channels": 2, "num_layers": 1, "kernel_size": 3, "channel_size": 8},
    "recursive": {"alpha_residual": True, "in_channels": 8, "num_layers": 2, "kernel_size": 3},
    "decoder": {"deconv": {"in_channels": 8, "kernel_size": 3, "stride": 3, "out_channels": 8},
                "final": {"in_channels": 8, "kernel_size": 1, "out_channels": 1}},
}


def small_config(name: str, **training) -> dict:
    """A benchmark configuration (``perfbench/configs/<name>.json``) at the
    small network's widths and batch 4."""
    config = json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text())
    config["network"] = copy.deepcopy(SMALL_NETWORK)
    config["training"].update(batch_size=4, **training)
    return config


def make_batch(config: dict, views: int, seed: int, device) -> tuple:
    t = config["training"]
    b, p = t["batch_size"], t["patch_size"]
    g = torch.Generator().manual_seed(seed)
    lrs = torch.rand((b, views, p, p), generator=g)
    alphas = torch.ones((b, views))
    hrs = torch.rand((b, 3 * p, 3 * p), generator=g)
    hr_maps = (torch.rand((b, 3 * p, 3 * p), generator=g) > 0.05).float()
    return tuple(x.to(device) for x in (lrs, alphas, hrs, hr_maps))


# -- the policy (CPU) ---------------------------------------------------------


@pytest.mark.parametrize("eligible, warm, seen, captured, full, way", [
    (False, True, False, False, False, EAGER),  # the CPU, a synced step
    (False, True, True, False, False, EAGER),
    (False, True, True, True, False, EAGER),
    (True, True, False, False, False, EAGER),  # a first sighting
    (True, True, True, False, False, CAPTURE),  # the second
    (True, False, True, False, False, EAGER),  # Adam's state or a gradient still to make
    (True, True, True, False, True, EAGER),  # KEYS keys hold graphs
    (True, True, False, True, False, REPLAY),
    (True, True, True, True, True, REPLAY),
])
def test_decide(eligible, warm, seen, captured, full, way):
    assert graphs.decide(eligible, warm, seen, captured, full) == way


def test_eligible_devices():
    assert not graphs.eligible(torch.device("cpu"), synced=False)
    assert not graphs.eligible(torch.device("cuda", 0), synced=True)
    assert graphs.eligible(torch.device("cuda", 0), synced=False)


def run_policy(policy: graphs.GraphedStep, key) -> str:
    way = policy.action(key)
    if way == CAPTURE:
        policy.graphs[key] = object()
    return way


def test_first_sighting_eager_second_captures_later_replay():
    policy = graphs.GraphedStep()
    assert [run_policy(policy, "a") for _ in range(4)] == [EAGER, CAPTURE, REPLAY, REPLAY]
    assert policy.action("b", eligible=False) == EAGER and "b" not in policy.seen
    assert policy.action("c", warm=False) == EAGER and "c" in policy.seen  # a sighting
    assert policy.action("c", warm=False) == EAGER and run_policy(policy, "c") == CAPTURE
    del policy.graphs["a"]  # a key whose graphs went stale starts again
    assert [run_policy(policy, "a") for _ in range(3)] == [EAGER, CAPTURE, REPLAY]


def test_a_new_shape_mode_generator_or_dtype_is_a_new_key():
    x = torch.zeros((2, 4, 16, 16))
    batch = (x, torch.ones((2, 4)), torch.zeros((2, 48, 48)), torch.ones((2, 48, 48)))
    gen = torch.Generator()
    mode = (0.0, 0.5)  # (the clip, ShiftNet's dropout rate)
    key = graphs.step_key(batch, mode, gen)
    assert graphs.step_key(tuple(t.clone() for t in batch), mode, gen) == key
    others = [
        graphs.step_key((torch.zeros((2, 6, 16, 16)),) + batch[1:], mode, gen),  # L 6
        graphs.step_key((x.double(),) + batch[1:], mode, gen),
        graphs.step_key(batch, (1.0, 0.5), gen),  # the clip on
        graphs.step_key(batch, (0.0, 0.0), gen),  # dropout off
        graphs.step_key(batch, mode, torch.Generator()),
    ]
    assert len({key, *others}) == 1 + len(others)


def test_the_cache_is_bounded():
    policy = graphs.GraphedStep()
    for k in range(KEYS):
        assert [run_policy(policy, k) for _ in range(2)] == [EAGER, CAPTURE]
    # full: a new key stays eager however often it comes, the old ones replay
    assert [run_policy(policy, "late") for _ in range(3)] == [EAGER] * 3
    assert all(run_policy(policy, k) == REPLAY for k in range(KEYS))
    assert len(policy.graphs) == KEYS
    for k in range(10 * SEEN):
        policy.action(("once", k))
    assert len(policy.seen) == SEEN


# -- the lr and the metrics (CPU) ---------------------------------------------


def tiny_state(config, device="cpu") -> TrainState:
    return create_train_state(config, device, torch.Generator().manual_seed(0))


def test_with_learning_rate_sets_the_lr_the_step_reads():
    config = small_config("hrnet-reference")
    step = build_train_step(config)
    batch = make_batch(config, 2, 0, "cpu")
    moves = {}
    for lr in (1e-3, 1e-5):
        state = tiny_state(config).with_learning_rate(lr)
        assert state.learning_rate == lr
        before = [p.detach().clone() for p in state.hrnet.parameters()]
        step(state, *batch)
        # Adam's first step moves each weight by about lr where it has a gradient
        moves[lr] = max((p.detach() - b).abs().max().item()
                        for p, b in zip(state.hrnet.parameters(), before))
    assert moves[1e-3] == pytest.approx(1e-3, rel=1e-2)
    assert moves[1e-5] == pytest.approx(1e-5, rel=1e-2)


def test_a_capturable_lr_is_written_in_place_and_kept_on_load():
    config = small_config("hrnet-reference")
    state = tiny_state(config)
    state.optimizer = make_optimizer(list(state.optimizer.param_groups[0]["params"]), 1e-3,
                                     capturable=True)
    lr = state.optimizer.param_groups[0]["lr"]
    assert isinstance(lr, torch.Tensor) and state.optimizer.param_groups[0]["capturable"]
    assert state.with_learning_rate(2.5e-4).optimizer.param_groups[0]["lr"] is lr
    assert lr.item() == pytest.approx(2.5e-4) and state.learning_rate == pytest.approx(2.5e-4)
    # a checkpoint from the CPU (a float lr, not capturable) keeps this lr tensor
    saved = tiny_state(config).with_learning_rate(0.5).state_dict()
    state.load_state_dict(saved)
    group = state.optimizer.param_groups[0]
    assert group["lr"] is lr and group["capturable"] and lr.item() == 0.5


def test_the_step_returns_metrics_later_steps_do_not_overwrite():
    config = small_config("hrnet-flagship")
    state, step = tiny_state(config), build_train_step(config)
    kept = []
    for seed in range(3):
        state, m = step(state, *make_batch(config, 4, seed, "cpu"))
        kept.append((m, {k: v.clone() for k, v in m.items()}))
    for m, copy_ in kept:
        assert all(torch.equal(m[k], copy_[k]) for k in m)
    assert len({float(m["loss"]) for m, _ in kept}) == 3


# -- replay against eager on the card ------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from highresnet_tpu_torch.runtime import setup_device

    return setup_device("cuda")


# (config, training overrides): the two benchmark configurations, and the
# flagship with the EMA, the clip, the range penalty and K3's warp
CASES = {
    "flagship": ("hrnet-flagship", {}),
    "reference": ("hrnet-reference", {}),
    "flagship-options": ("hrnet-flagship", {"ema_decay": 0.99, "grad_clip_norm": 0.05,
                                            "range_penalty": 10.0, "warp_int_range": 0,
                                            "use_pallas_warp": True}),
}
# the views of each step: a shape change after step 3 (a new key, eager then
# captured) and back; the lr falls after step 4
VIEWS = {"hrnet-flagship": [4, 4, 4, 6, 6, 6, 4, 4], "hrnet-reference": [2, 2, 2, 4, 4, 4, 2, 2]}
LR_STEP = 4


def run_steps(config, views, device, graphed: bool, monkeypatch, state=None, first=0, n=None,
              step=None):
    """Steps ``first`` to ``first + n`` (to the end of ``views``, each step's
    view count) on a fresh (or the given) state and step function, with
    graphs or eagerly; returns the state, each step's metrics, the count of
    captures and replays, and the step function."""
    counts = {"capture": 0, "replay": 0}
    capture, replay = graphs.capture, graphs.StepGraphs.replay

    def counted_capture(*a, **k):
        counts["capture"] += 1
        return capture(*a, **k)

    def counted_replay(self, batch):
        counts["replay"] += 1
        return replay(self, batch)

    with monkeypatch.context() as m:
        m.setattr(graphs, "capture", counted_capture)
        m.setattr(graphs.StepGraphs, "replay", counted_replay)
        if not graphed:
            m.setattr(step_module, "eligible", lambda device, synced: False)
        state = state or tiny_state(config, device)
        step = step or build_train_step(config)
        metrics = []
        for i in range(first, first + (n or len(views) - first)):
            if i == LR_STEP:
                state = state.with_learning_rate(state.learning_rate / 4)
            state, out = step(state, *make_batch(config, views[i], 100 + i, device))
            metrics.append(out)
    return state, metrics, counts, step


def assert_same_state(a: TrainState, b: TrainState) -> None:
    for name in ("hrnet", "shiftnet"):
        sa, sb = getattr(a, name).state_dict(), getattr(b, name).state_dict()
        for k in sa:  # parameters and BatchNorm's running statistics
            assert torch.equal(sa[k], sb[k]), (name, k)
    for p, q in zip(a.optimizer.param_groups[0]["params"], b.optimizer.param_groups[0]["params"]):
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        assert set(sa) == set(sb) == {"step", "exp_avg", "exp_avg_sq"}
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    if a.ema is not None:
        for name in a.ema:
            assert all(torch.equal(a.ema[name][k], b.ema[name][k]) for k in a.ema[name])
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert a.step == b.step and a.learning_rate == b.learning_rate


def assert_same_metrics(got, want) -> None:
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "mean_abs_shift", "max_abs_shift", "grad_norm"):
            assert torch.equal(g[k], w[k]), (i, k, g[k].item(), w[k].item())


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_replayed_steps_equal_eager_steps_bit_for_bit(case, cuda, monkeypatch):
    from highresnet_tpu_torch.ops import fusion, lanczos_fused

    name, overrides = CASES[case]
    config = small_config(name, **overrides)
    assert config["training"].get("register", True)  # dropout draws in ShiftNet
    launches = {}
    runs = {}
    for graphed in (False, True):
        before = (dict(fusion.LAUNCHES), lanczos_fused.LAUNCHES)
        runs[graphed] = run_steps(config, VIEWS[name], cuda, graphed, monkeypatch)
        launches[graphed] = ({k: fusion.LAUNCHES[k] - before[0][k] for k in fusion.LAUNCHES},
                             lanczos_fused.LAUNCHES - before[1])
    (eager, eager_m, eager_n, _), (replayed, replayed_m, n, _) = runs[False], runs[True]
    # two keys: steps 0, 3 eager; 1, 4 captured and replayed; the rest replayed
    assert eager_n == {"capture": 0, "replay": 0}
    assert n == {"capture": 2, "replay": len(VIEWS[name]) - 2}
    assert_same_metrics(replayed_m, eager_m)
    assert_same_state(replayed, eager)
    assert launches[True] == launches[False] and launches[True][0]["pack"] > 0
    assert (launches[True][1] > 0) == bool(overrides.get("use_pallas_warp"))


@pytest.mark.cuda
@pytest.mark.parametrize("fresh", [True, False])
def test_a_resumed_run_replays_what_a_straight_run_does(fresh, cuda, monkeypatch):
    """A run resumed after step 3 ends where a straight run does: on a fresh
    state and step function (a new process), or on the same ones (Adam's
    state replaced under the key's graphs, which go and capture again)."""
    config = small_config("hrnet-flagship")
    views = VIEWS["hrnet-flagship"]
    straight, straight_m, _, _ = run_steps(config, views, cuda, True, monkeypatch)
    half, _, _, step = run_steps(config, views, cuda, True, monkeypatch, n=LR_STEP)
    saved = copy.deepcopy(half.state_dict())
    resumed = tiny_state(config, cuda) if fresh else half
    resumed.load_state_dict(saved)
    resumed, resumed_m, n, _ = run_steps(config, views, cuda, True, monkeypatch, state=resumed,
                                         first=LR_STEP, step=None if fresh else step)
    # fresh: steps 4 and 6 eager (first sightings), 5 and 7 captured. The same
    # step function saw L 6 at step 3, so it captures at step 4 and replays at
    # 5; L 4's graphs went with the replaced Adam state: 6 eager, 7 captured
    assert n == {"capture": 2, "replay": 2 if fresh else 3}
    assert_same_metrics(resumed_m, straight_m[LR_STEP:])
    assert_same_state(resumed, straight)
