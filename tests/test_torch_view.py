"""The port's view axis (``training.mesh = {"data": D, "view": M}``) on the CPU.

- The pack identity the view-sharded fusion rests on: ``pack_pairs_ref`` of
  a rank's block ``cat(x[:, j0:j1], x[:, 2·half−j1 : 2·half−j0])`` is that
  rank's slice [j0, j1) of the whole pack, bit for bit (odd L included).
- One train step on ``{"data": 2, "view": 2}`` at L 4, four Gloo ranks
  (``tests/_torch_ranks.py``), against JAX's own 2-D step on four virtual
  CPU devices (``shard_views=True``, as tests/test_parallel.py runs it) from
  the same weights, dropout off (ROADMAP H3), registration crop 32 px
  (ROADMAP H8): loss rtol 1e-5, each gradient within 1e-4 of its tensor's
  norm, the ranks bit-identical.
- In the same launch, ``{"data": 1, "view": 4}`` at L 8 with dropout on
  against the port's one-process step: round 1 sharded (one pair a rank),
  rounds 2-3 replicated, the same tolerances and the same dropout draws.
- JAX's config errors (tests/test_parallel.py::test_loop_mesh_config_validation)
  with the same words in both packages, the port's divergence from JAX
  (``training.mesh`` across processes) and its refusal of a batch whose L
  does not divide over the view ranks.
"""

import copy

import numpy as np
import pytest
import torch

import _torch_ranks as tr
from highresnet_tpu.parallel.mesh import make_mesh
from highresnet_tpu_torch.data.synth import make_synthetic_dataset
from highresnet_tpu_torch.models import hrnet
from highresnet_tpu_torch.ops.fusion import pack_pairs_ref
from highresnet_tpu_torch.parallel import mesh
from highresnet_tpu_torch.train.state import create_train_state
from highresnet_tpu_torch.train.step import build_train_step
from test_torch_parallel import (
    DP_CONFIG,
    LOSS_RTOL,
    _assert_ranks_equal,
    _assert_step_close,
    _jax_step,
)


def _config(batch: int, views: int, **layout) -> dict:
    cfg = copy.deepcopy(DP_CONFIG)
    cfg["training"].update(batch_size=batch, min_L=views, n_views=views, mesh=layout)
    return cfg


VIEW_2D = _config(8, 4, data=2, view=2)
VIEW_TREE = _config(4, 8, data=1, view=4)


@pytest.mark.parametrize("l, m, v", [(4, 2, 0), (4, 2, 1), (8, 2, 1), (8, 4, 3), (16, 4, 2),
                                     (5, 2, 1), (13, 3, 0), (13, 3, 2)])
def test_block_pack_is_a_slice_of_the_whole_pack(l, m, v):
    x = torch.from_numpy(np.random.default_rng(l * 10 + v).random((2, l, 3, 4, 5), np.float32))
    half = l // 2
    j0, j1 = v * half // m, (v + 1) * half // m
    block = torch.cat([x[:, j0:j1], x[:, 2 * half - j1:2 * half - j0]], dim=1)
    assert torch.equal(pack_pairs_ref(block), pack_pairs_ref(x)[:, j0:j1])


def _inputs(config: dict, dropout: float) -> dict:
    """The seeded port state of ``config`` with a random fc2 (nonzero shifts)
    and one global batch of its batch size and views."""
    state = create_train_state(config, "cpu", torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    with torch.no_grad():
        state.shiftnet.fc2.weight.copy_(
            torch.from_numpy(rng.normal(0, 0.02, (2, 1024)).astype(np.float32)))
    t = config["training"]
    b, l, p = t["batch_size"], t["min_L"], t["patch_size"]
    batch = (
        rng.random((b, l, p, p)).astype(np.float32),
        np.ones((b, l), np.float32),
        rng.random((b, 3 * p, 3 * p)).astype(np.float32),
        np.ones((b, 3 * p, 3 * p), np.float32),
    )
    return {"config": config, "hrnet": state.hrnet.state_dict(),
            "shiftnet": state.shiftnet.state_dict(), "dropout": dropout,
            "generator": state.generator.get_state(), "batch": batch}


@pytest.fixture(scope="module")
def view_ranks(tmp_path_factory):
    """Both layouts' four ranks, started together."""
    inputs = {"2d": _inputs(VIEW_2D, dropout=0.0), "tree": _inputs(VIEW_TREE, dropout=0.5)}
    outs = tr.launch_jobs([("step", inp, tag, 4) for tag, inp in inputs.items()],
                          tmp_path_factory.mktemp("view"))
    return {tag: (inputs[tag], ranks) for tag, ranks in zip(inputs, outs)}


def test_2d_step_matches_jax_2d_step(view_ranks, monkeypatch):
    inp, ranks = view_ranks["2d"]
    jax_mesh = make_mesh(n_devices=4, shape=(2, 2), axis_names=("data", "view"))
    want_loss, want = _jax_step(inp, monkeypatch, jax_mesh=jax_mesh)
    _, want_grads = _jax_step(inp, monkeypatch, capture=True, jax_mesh=jax_mesh)
    grads = {k: v for k, v in want_grads.items() if k.split(".")[-1] in ("weight", "bias")}
    for r in ranks:
        assert r["packs"] == [2, 2]  # round 1: one pair a rank; round 2 replicated
        assert _assert_step_close(r, want_loss, want, grads) > 0.99
    _assert_ranks_equal(ranks)


def test_sharded_then_replicated_tree_matches_one_process(view_ranks):
    inp, ranks = view_ranks["tree"]
    state = tr.port_state(inp)
    state, metrics = build_train_step(inp["config"])(
        state, *[torch.from_numpy(a) for a in inp["batch"]])
    want = tr.step_result(state, metrics)
    for r in ranks:
        assert r["packs"] == [2, 4, 2]  # round 1: one pair a rank; rounds 2-3 replicated
        assert _assert_step_close(r, want["metrics"]["loss"], want["params"], want["grads"]) > 0.99
        for k in ("mean_abs_shift", "max_abs_shift", "grad_norm"):
            np.testing.assert_allclose(r["metrics"][k], want["metrics"][k], rtol=LOSS_RTOL,
                                       err_msg=k)
        assert torch.equal(r["generator"], want["generator"])  # the same dropout draws
    assert want["metrics"]["max_abs_shift"] > 0.0
    _assert_ranks_equal(ranks)


# --- the layout's checks ----------------------------------------------------------


@pytest.mark.parametrize("mesh_cfg, world, match", [
    ({"data": 16, "view": 1}, 8, "exceeds"),
    ({"data": 2, "view": 1}, 8, "batch_size"),
    ({"data": 1, "view": 3}, 8, "min_L"),
    # fewer scenes than one batch: meshed runs drop ragged batches and
    # would otherwise silently train zero steps per epoch
    ({"data": 1, "view": 1}, 1, "local training scenes"),
])
def test_mesh_config_errors_match_jax(tmp_path, monkeypatch, mesh_cfg, world, match):
    """tests/test_parallel.py::test_loop_mesh_config_validation's configs in
    both loops; the JAX one on the conftest's 8 virtual devices, the port's
    in a stand-in group of as many processes."""
    from highresnet_tpu.train.loop import train_and_get_best_model as jax_train
    from highresnet_tpu_torch.train.loop import train_and_get_best_model

    root = tmp_path / "data_v"
    make_synthetic_dataset(str(root), n_scenes_per_channel=1, n_views=4, lr_size=24, seed=0,
                           splits=("train",))
    cfg = {
        "network": {},
        "training": {
            "batch_size": 3, "min_L": 4, "n_views": 4, "crop": 1, "lr": 1e-3,
            "lr_step": 2, "lr_decay": 0.97, "beta": 50.0, "patch_size": 16,
            "register_size": 32, "val_proportion": 0.5, "lambda": 1e-6,
            "num_epochs": 1, "n_workers": 1, "seed": 0, "mesh": mesh_cfg,
        },
        "paths": {"prefix": str(root), "checkpoint_dir": str(tmp_path / "c"),
                  "tb_log_file_dir": ""},
    }
    with pytest.raises(ValueError, match=match):
        jax_train(copy.deepcopy(cfg))
    if world > 1:
        monkeypatch.setattr(mesh, "process_count", lambda: world)
        monkeypatch.setattr(mesh, "is_initialized", lambda: True)
    with pytest.raises(ValueError, match=match):
        train_and_get_best_model(cfg, device="cpu")


def test_layout_of_a_2d_mesh(monkeypatch):
    """Rank 5 of {"data": 3, "view": 2}: its indices, groups and batch."""
    made = []
    monkeypatch.setattr(mesh, "process_count", lambda: 6)
    monkeypatch.setattr(mesh, "process_index", lambda: 5)
    monkeypatch.setattr(mesh, "is_initialized", lambda: True)
    monkeypatch.setattr(mesh.dist, "new_group", lambda ranks: made.append(ranks) or tuple(ranks))
    t = copy.deepcopy(DP_CONFIG["training"])
    t.update(batch_size=6, min_L=4, mesh={"data": 3, "view": 2})
    layout = mesh.setup_data_parallel(t, torch.device("cpu"))
    assert made == [[0, 2, 4], [1, 3, 5], [0, 1], [2, 3], [4, 5]]  # every group, on every rank
    assert (layout.data, layout.view, layout.d, layout.v) == (3, 2, 2, 1)
    assert layout.data_group == (1, 3, 5) and layout.view_group == (4, 5)
    assert layout.local_batch == 2 and layout.drop_last and layout.synced
    assert layout.eval_batch(1) == 1 and layout.eval_batch(4) == 6


def test_views_that_do_not_divide_over_the_view_ranks_raise(monkeypatch):
    net = hrnet.HRNet(copy.deepcopy(DP_CONFIG["network"]))
    monkeypatch.setattr(hrnet, "process_count", lambda group=None: 2)
    monkeypatch.setattr(hrnet, "process_index", lambda group=None: 0)
    net.shard_views(object())
    with pytest.raises(ValueError, match="3 views do not divide over view=2"):
        net.train()(torch.zeros(1, 3, 8, 8), torch.ones(1, 3))
    net.eval()(torch.zeros(1, 3, 8, 8), torch.ones(1, 3))  # eval runs the whole forward


def test_view_ranks_can_build_one_epoch_cache_variant_at_once(tmp_path, monkeypatch):
    """The view ranks of a replica share its cache key (the data index) and
    build each variant together: a build that commits while another is still
    writing leaves whole files that serve the same batches."""
    import os

    from highresnet_tpu_torch.data import discover_scenes
    from highresnet_tpu_torch.train.setup import build_train_loader

    root = str(tmp_path / "set")
    make_synthetic_dataset(root, n_scenes_per_channel=2, n_views=4, lr_size=16, seed=0,
                           splits=("train",))
    t = {"batch_size": 2, "min_L": 4, "n_views": 4, "patch_size": 16, "beta": 50.0,
         "create_patches": False, "shuffle": False, "n_workers": 1, "epoch_cache_variants": 1}
    scenes = discover_scenes(os.path.join(root, "train"))
    first, other = (build_train_loader(t, scenes, seed=0, data_dir=root) for _ in range(2))
    real, pending = os.replace, [other]

    def replace(src, dst):
        if pending:  # the other rank builds and commits while this one writes
            with monkeypatch.context() as m:
                m.setattr(os, "getpid", lambda: -1)
                list(pending.pop())
        real(src, dst)

    monkeypatch.setattr(os, "replace", replace)
    built = list(first)
    monkeypatch.undo()
    assert not pending and not [f for f in os.listdir(first.cache_dir) if "tmp" in f]
    served = list(build_train_loader(t, scenes, seed=0, data_dir=root))
    assert len(served) == len(built) == 2
    for a, b in zip(built, served):
        assert tuple(a.names) == b.names
        assert np.array_equal(a.lrs, b.lrs) and np.array_equal(a.hrs, b.hrs)
