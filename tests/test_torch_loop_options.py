"""The port's training loop against the JAX package's on the loop's options.

``test_torch_loop_parity.py`` holds the port's ``train_and_get_best_model``
to JAX's on the recipe's own keys. This file holds it on the four options
that decide which weights a run ships and when it stops:

- ``training.grad_clip_norm``: optax.clip_by_global_norm before Adam, set
  to the median gradient norm of an unclipped run's first epoch, so it
  binds on some steps and not on others;
- ``training.early_stop_patience`` 1 at lr 0 after the donor start (the
  val score never improves after epoch 1, as in the JAX package's own
  test): both stop at epoch 2 with best epoch 1; relaunched in the same run
  directory with more epochs, both stop again after one epoch and serve the
  same ``best/``;
- ``training.cache_val_batches`` false: the val views drawn anew each epoch
  from ``default_rng((seed, 1000003, epoch))``;
- ``training.val_views`` [2, 1]: the selection score is the mean of the
  full stack's score and those of its 2 and 1 clearest views.

Both packages run in float64 from the shared harness's JAX donor
(``_loop_harness.py``) and are held to each other within ``F64_RTOL``
(1e-8, relative), the limit of the parity file's float64 test: every
epoch's mean train loss, selection score, raw and EMA val scores and LR,
each step's gradient norm, the val history and the HRNet after the last
epoch; the best epoch, the stop epoch and the val history's epochs equal.
The file is apart from the parity file so that ``--dist loadfile`` gives it
a worker of its own.
"""

import hashlib
import statistics

import jax
import numpy as np
import pytest

import highresnet_tpu.train.pretrain as jax_pretrain
from _loop_harness import (  # noqa: F401  (donor, few_threads: fixtures)
    CONFIG,
    F64_RTOL,
    QUANTITIES,
    _port_params,
    _flat,
    _rel,
    _run,
    donor,
    few_threads,
)
from highresnet_tpu_torch.data import discover_scenes, train_val_split
from highresnet_tpu_torch.train.evaluation import build_val_batches

EPOCHS = 2  # epoch 1 unregistered (register_warmup_epochs 1), epoch 2 registered
PATIENCE = 1
STOP_EPOCHS = 4  # the early-stopped run's num_epochs; its relaunch's is RELAUNCH_EPOCHS
RELAUNCH_EPOCHS = 6
VAL_VIEWS = [2, 1]


@pytest.fixture(autouse=True, scope="module")
def one_jax_warmstart():
    """JAX's ShiftNet warm-start computed once per distinct input: every run
    here starts it from the same donor on the same injected draws, and its
    float64 compile is most of a JAX run's time. A call whose arrays and
    arguments hash alike returns copies of the first result."""
    real, results = jax_pretrain.pretrain_shiftnet, {}

    def digest(*trees, **kwargs):
        h = hashlib.sha256(repr(sorted(kwargs.items())).encode())
        for leaf in jax.tree.leaves(trees):
            a = np.asarray(leaf)
            h.update(f"{a.dtype}{a.shape}".encode())
            h.update(a.tobytes())
        return h.hexdigest()

    def pretrain_shiftnet(shiftnet, params, batch_stats, images, rng, **kwargs):
        key = digest(params, batch_stats, images, jax.random.key_data(rng),
                     x64=jax.config.jax_enable_x64, **kwargs)
        if key not in results:
            results[key] = real(shiftnet, params, batch_stats, images, rng, **kwargs)
        return jax.tree.map(lambda x: x.copy() if hasattr(x, "copy") else x, results[key])

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax_pretrain, "pretrain_shiftnet", pretrain_shiftnet)
        yield


def _close(got, want):
    return abs(got - want) <= F64_RTOL * abs(want)


def _assert_same_run(want, got, jax_out, port_out):
    """The two traces and results agree: epoch by epoch, then the selection."""
    assert len(got) == len(want)
    for epoch, (w, g) in enumerate(zip(want, got), start=1):
        assert g["steps"] == w["steps"], epoch
        for q in QUANTITIES + ("lr",):
            assert _close(g[q], w[q]), (epoch, q, g[q], w[q])
        for i, (gn, wn) in enumerate(zip(g["grad_norms"], w["grad_norms"])):
            assert _close(gn, wn), (epoch, i, gn, wn)
    assert port_out["best_epoch"] == jax_out["best_epoch"]
    assert [e for e, _ in port_out["val_history"]] == [e for e, _ in jax_out["val_history"]]
    for (_, g), (_, w) in zip(port_out["val_history"], jax_out["val_history"]):
        assert _close(g, w), (g, w)
    assert _close(port_out["best_score"], jax_out["best_score"])
    for k, w in want[-1]["hrnet"].items():
        assert _rel(got[-1]["hrnet"][k], w) <= F64_RTOL, k


def _both(donor, monkeypatch, name, **training):
    want, jax_out = _run(donor, monkeypatch, "jax", f"jax_{name}", float64=True, **training)
    got, port_out = _run(donor, monkeypatch, "port", f"port_{name}", float64=True, **training)
    return want, got, jax_out, port_out


@pytest.fixture(scope="module")
def early_stopped(donor):
    """Both packages' runs at lr 0 with ``early_stop_patience`` 1."""
    with pytest.MonkeyPatch.context() as m:
        return _both(donor, m, "early_stop", lr=0.0, early_stop_patience=PATIENCE,
                     num_epochs=STOP_EPOCHS)


def _grad_clip(donor, monkeypatch):
    unclipped, _ = _run(donor, monkeypatch, "port", "port_unclipped", float64=True, num_epochs=1)
    clip = statistics.median(unclipped[0]["grad_norms"])
    print(f"grad_clip_norm {clip!r}: the median of the unclipped first epoch's gradient norms "
          f"{unclipped[0]['grad_norms']}")
    runs = _both(donor, monkeypatch, "grad_clip", grad_clip_norm=clip, num_epochs=EPOCHS)
    for trace in runs[:2]:
        norms = [n for e in trace for n in e["grad_norms"]]
        assert any(n >= clip for n in norms) and any(n < clip for n in norms), (clip, norms)
    return runs


def _uncached_val(donor, monkeypatch):
    """The per-epoch draws differ from each other (so the option is seen),
    and both packages score the same ones."""
    t = CONFIG["training"]
    _, val = train_val_split(discover_scenes(f"{donor['root']}/train"), t["val_proportion"],
                             seed=1)
    draws = [build_val_batches(val, t["min_L"], t["n_views"], t["beta"], t["eval_batch_size"],
                               rng=np.random.default_rng((t["seed"], 1000003, epoch)))
             for epoch in range(1, EPOCHS + 1)]
    assert not all(np.array_equal(a[1][0], b[1][0]) for a, b in zip(*draws))
    return _both(donor, monkeypatch, "uncached_val", cache_val_batches=False, num_epochs=EPOCHS)


def _early_stop(donor, monkeypatch, request):
    want, got, jax_out, port_out = request.getfixturevalue("early_stopped")
    # the val score never improves at lr 0: best at epoch 1, stopped at 1 + patience
    assert len(want) == len(got) == 1 + PATIENCE < STOP_EPOCHS
    assert jax_out["best_epoch"] == 1
    return want, got, jax_out, port_out


OPTIONS = {
    "grad_clip_norm": lambda donor, mp, request: _grad_clip(donor, mp),
    "early_stop_patience": _early_stop,
    "cache_val_batches": lambda donor, mp, request: _uncached_val(donor, mp),
    "val_views": lambda donor, mp, request: _both(
        donor, mp, "val_views", val_views=VAL_VIEWS, num_epochs=EPOCHS),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_option_matches_jax_in_float64(option, donor, monkeypatch, request):
    want, got, jax_out, port_out = OPTIONS[option](donor, monkeypatch, request)
    _assert_same_run(want, got, jax_out, port_out)


def test_early_stop_relaunch_restops_as_jax(early_stopped, donor, monkeypatch):
    """The early-stopped run directories relaunched with more epochs: both
    resume at epoch 2 + 1, find no improvement and stop there, and serve the
    best/ weights the first runs wrote. The relaunched epoch's train loss is
    not compared: the JAX loop restarts its loader's sampling at epoch 0 on
    a resume, the port draws what an uninterrupted run would."""
    first_jax, first_port = early_stopped[2], early_stopped[3]
    want, jax_out = _run(donor, monkeypatch, "jax", "jax_early_stop", float64=True, lr=0.0,
                         early_stop_patience=PATIENCE, num_epochs=RELAUNCH_EPOCHS)
    got, port_out = _run(donor, monkeypatch, "port", "port_early_stop", float64=True, lr=0.0,
                         early_stop_patience=PATIENCE, num_epochs=RELAUNCH_EPOCHS)
    assert len(want) == len(got) == 1  # re-stopped after one epoch
    for q in ("val", "raw", "ema", "lr"):
        assert _close(got[0][q], want[0][q]), (q, got[0][q], want[0][q])
    assert port_out["best_epoch"] == jax_out["best_epoch"] == first_jax["best_epoch"]
    stopped = 1 + PATIENCE
    assert [e for e, _ in port_out["val_history"]] == [e for e, _ in jax_out["val_history"]] \
        == list(range(1, stopped + 2))
    assert _close(port_out["best_score"], jax_out["best_score"])
    served_jax = _flat(jax_out["params"]["hrnet"])
    served_port = _port_params(port_out["params"]["hrnet"])
    first = _port_params(first_port["params"]["hrnet"])
    for k, w in served_jax.items():
        assert _rel(served_port[k], w) <= F64_RTOL, k
        np.testing.assert_array_equal(served_port[k], first[k])
