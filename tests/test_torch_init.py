"""The port's initial weights against the JAX package's, by distribution.

The JAX package builds its layers with flax's defaults: every conv and
dense kernel (and the decoder's ``deconv_kernel`` and 1×1 conv, which name
it explicitly) from ``lecun_normal``, a normal of std sigma =
sqrt(1 / fan_in) / 0.87962566 truncated at ±2 sigma, with fan_in the
product of the kernel's JAX shape but its last axis; biases zero; PReLU
0.25; BatchNorm (1, 0); ShiftNet's ``fc2`` zero. The port cannot draw
JAX's threefry numbers, so it is held to the distribution: both models
are built at configs/config.json's width (ShiftNet at register 128), every
parameter is paired through ``models/convert.py``'s name maps, and each
kernel of 4096 elements or more must show the truncated normal's std
(sigma · 0.87962566, within 3%), stay inside ±2 sigma and have a mean
within 4 sigma / sqrt(n) of zero. The deconv's fan_in is checked where its
input and output widths differ, so torch's own fan-in helper (which reads
the output width from a ConvTranspose2d weight) would fail it.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from highresnet_tpu.models.hrnet import HRNet as JaxHRNet
from highresnet_tpu.models.shiftnet import ShiftNet as JaxShiftNet
from highresnet_tpu_torch.config import load_config
from highresnet_tpu_torch.models import (
    HRNet,
    ShiftNet,
    hrnet_state_dict_from_flax,
    shiftnet_state_dict_from_flax,
)
from highresnet_tpu_torch.models.layers import lecun_normal_
from highresnet_tpu_torch.models.vgg import CONV_SPECS, seeded_state

TRUNC_STD = 0.87962566103423978
STD_RTOL = 0.03
MIN_STATS_SIZE = 4096
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET = load_config(os.path.join(REPO, "configs", "config.json"))["network"]
# the deconv 64 -> 16: JAX's fan_in 64·9, torch's helper would take 16·9
NARROW_DECONV = {
    **NET,
    "decoder": {
        "deconv": {**NET["decoder"]["deconv"], "out_channels": 16},
        "final": {**NET["decoder"]["final"], "in_channels": 16},
    },
}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs files side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _fans(params):
    """The tree with each kernel replaced by its JAX fan_in (the product of
    its shape but the last axis) and every other leaf by 0, so the name map
    that converts the params carries each kernel's fan_in to its torch key."""
    def fan(path, leaf):
        kernel = "kernel" in jax.tree_util.keystr(path)
        return np.full(leaf.shape, math.prod(leaf.shape[:-1]) if kernel else 0, np.float32)

    return jax.tree_util.tree_map_with_path(fan, params)


def _paired(state, fan_state):
    """{torch key: (JAX value, fan_in, or None for a leaf JAX does not draw)}."""
    return {k: (v, int(fan_state[k].flatten()[0]) or None) for k, v in state.items()}


def _jax_hrnet(net):
    params = JaxHRNet(config=net).init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 8, 8)),
                                       jnp.ones((1, 2)))["params"]
    params = jax.device_get(params)
    return _paired(hrnet_state_dict_from_flax(params), hrnet_state_dict_from_flax(_fans(params)))


@pytest.fixture(scope="module")
def jax_shiftnet():
    variables = JaxShiftNet().init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 2)),
                                   train=False)
    params, stats = jax.device_get((variables["params"], variables["batch_stats"]))
    return _paired(shiftnet_state_dict_from_flax(params, stats),
                   shiftnet_state_dict_from_flax(_fans(params), stats))


def _fan_in_port(key: str, weight: torch.Tensor) -> int:
    """The JAX fan_in of a port weight, from the port's layout: a conv's
    in·k·k, the deconv's in·s·s (dim 0 of torch's (in, out, s, s)), a dense
    layer's in_features."""
    if key.startswith("decode.deconv"):
        return weight.shape[0] * weight.shape[2] * weight.shape[3]
    return math.prod(weight.shape[1:])


def _check_kernel(name: str, w: np.ndarray, fan_in: int) -> None:
    sigma = math.sqrt(1.0 / fan_in) / TRUNC_STD
    assert np.abs(w).max() <= 2 * sigma * (1 + 1e-6), name
    if w.size >= MIN_STATS_SIZE:
        np.testing.assert_allclose(w.std(), sigma * TRUNC_STD, rtol=STD_RTOL, err_msg=name)
        assert abs(w.mean()) <= 4 * sigma / math.sqrt(w.size), name


def _check_pairs(want, got):
    """Every JAX parameter has its port twin: same shape, exact values where
    JAX's are constant, the same distribution where JAX draws."""
    assert got.keys() == want.keys()
    for key, (jax_value, fan_in) in want.items():
        w = got[key].detach().numpy()
        j = np.asarray(jax_value)
        assert w.shape == j.shape, key
        if key.endswith("num_batches_tracked"):
            continue
        if fan_in is None or not np.any(j):  # a constant in JAX: the same constant
            assert np.array_equal(w, j), key
            continue
        assert fan_in == _fan_in_port(key, got[key]), key
        _check_kernel(f"jax {key}", j, fan_in)
        _check_kernel(f"port {key}", w, fan_in)


@pytest.mark.parametrize("net", [NET, NARROW_DECONV], ids=["config", "deconv_64_to_16"])
def test_hrnet_init_matches_jax(net):
    want = _jax_hrnet(net)
    got = HRNet(net, generator=torch.Generator().manual_seed(0)).state_dict()
    _check_pairs(want, got)
    for key, value in got.items():
        if key.endswith("bias"):
            assert not value.any(), key
        elif value.numel() == 1:
            assert value.item() == 0.25, key  # PReLU
    deconv = got["decode.deconv.0.weight"]
    if deconv.shape[0] != deconv.shape[1]:  # torch's helper takes dim 1: 16·9, not 64·9
        helper_fan_in = torch.nn.init._calculate_fan_in_and_fan_out(deconv)[0]
        assert helper_fan_in != _fan_in_port("decode.deconv.0.weight", deconv)


def test_shiftnet_init_matches_jax(jax_shiftnet):
    got = ShiftNet(register_size=128, generator=torch.Generator().manual_seed(0)).state_dict()
    _check_pairs(jax_shiftnet, got)
    assert not got["fc2.weight"].any() and not got["fc1.bias"].any()
    for i in range(1, 9):
        assert not got[f"layer{i}.0.bias"].any()
        assert torch.equal(got[f"layer{i}.1.weight"], torch.ones_like(got[f"layer{i}.1.weight"]))
        assert not got[f"layer{i}.1.bias"].any() and not got[f"layer{i}.1.running_mean"].any()
        assert torch.equal(got[f"layer{i}.1.running_var"],
                           torch.ones_like(got[f"layer{i}.1.running_var"]))


@pytest.mark.parametrize("build", [
    pytest.param(lambda g: HRNet(NET, generator=g).state_dict(), id="hrnet"),
    pytest.param(lambda g: ShiftNet(register_size=32, generator=g).state_dict(), id="shiftnet"),
])
def test_same_seed_same_weights(build):
    a, b = build(torch.Generator().manual_seed(5)), build(torch.Generator().manual_seed(5))
    other = build(torch.Generator().manual_seed(6))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], other[k]) for k in a)


def test_lecun_normal_helper_is_flax_lecun_normal():
    """The helper's draw against flax's own initialiser at one shape (by
    distribution), and the seeded VGG drawn through it."""
    shape = (3, 3, 64, 128)
    fan_in = 3 * 3 * 64
    want = np.asarray(jax.nn.initializers.lecun_normal()(jax.random.PRNGKey(0), shape))
    got = lecun_normal_(torch.empty(128, 64, 3, 3), fan_in, torch.Generator().manual_seed(0))
    _check_kernel("flax", want, fan_in)
    _check_kernel("port", got.numpy(), fan_in)
    np.testing.assert_allclose(got.std().item(), want.std(), rtol=STD_RTOL)
    state = seeded_state(0)
    g = torch.Generator().manual_seed(0)
    for index, in_ch, out_ch in CONV_SPECS:
        w = lecun_normal_(torch.empty(out_ch, in_ch, 3, 3), in_ch * 9, g)
        assert torch.equal(state[f"features.{index}.weight"], w), index
        assert not state[f"features.{index}.bias"].any()
