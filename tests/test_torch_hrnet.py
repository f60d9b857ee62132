"""The port's HRNet against the JAX HRNet on the same weights, the parameter
count, and the weight bridge in both directions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from highresnet_tpu.config import DEFAULT_CONFIG
from highresnet_tpu.models.convert import hrnet_params_from_torch
from highresnet_tpu.models.hrnet import HRNet as JaxHRNet
from highresnet_tpu.ops.metrics import cpsnr_np
from highresnet_tpu_torch.models import HRNet, hrnet_state_dict_from_flax, param_count

# narrow and shallow so the JAX compiles stay small
SMALL_NET = {
    "encoder": {"in_channels": 2, "num_layers": 1, "kernel_size": 3, "channel_size": 16},
    "recursive": {"alpha_residual": True, "in_channels": 16, "kernel_size": 3},
    "decoder": {
        "deconv": {"in_channels": 16, "kernel_size": 3, "stride": 3, "out_channels": 16},
        "final": {"in_channels": 16, "kernel_size": 1, "out_channels": 1},
    },
}
PATCH = 12


def _with_pack(net, flag):
    return {**net, "recursive": {**net["recursive"], "use_pallas_pack": flag}}


@pytest.fixture(scope="module")
def port_model():
    return HRNet(SMALL_NET, generator=torch.Generator().manual_seed(7)).eval()


@pytest.mark.parametrize("use_pack_kernel", [True, False])
@pytest.mark.parametrize("l", [2, 5, 8, 16])
def test_hrnet_matches_jax(port_model, l, use_pack_kernel):
    rng = np.random.default_rng(l)
    lrs = rng.random((2, l, PATCH, PATCH)).astype(np.float32)
    alphas = np.ones((2, l), np.float32)
    if l > 2:  # scene 1 carries alpha-0 padding views, zero-filled as collate pads
        alphas[1, l // 2 + 1 :] = 0.0
        lrs[1, l // 2 + 1 :] = 0.0

    model = HRNet(_with_pack(SMALL_NET, use_pack_kernel))
    model.load_state_dict(port_model.state_dict())
    with torch.inference_mode():
        got = model(torch.from_numpy(lrs), torch.from_numpy(alphas)).numpy()

    params = hrnet_params_from_torch(port_model.state_dict(), num_res_layers=1)
    jax_model = JaxHRNet(config=_with_pack(SMALL_NET, use_pack_kernel))
    want = np.asarray(jax_model.apply({"params": params}, jnp.asarray(lrs), jnp.asarray(alphas)))

    assert got.shape == want.shape == (2, 3 * PATCH, 3 * PATCH)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)
    hr = rng.random(got.shape)
    mask = np.ones_like(hr)
    d = np.abs(cpsnr_np(np.clip(got, 0, 1), hr, mask) - cpsnr_np(np.clip(want, 0, 1), hr, mask))
    assert d.max() < 1e-3, d


def test_param_count_default_config():
    model = HRNet(DEFAULT_CONFIG["network"])
    assert param_count(model) == 591_818


def test_seeded_init_is_reproducible():
    a = HRNet(SMALL_NET, generator=torch.Generator().manual_seed(3)).state_dict()
    b = HRNet(SMALL_NET, generator=torch.Generator().manual_seed(3)).state_dict()
    c = HRNet(SMALL_NET, generator=torch.Generator().manual_seed(4)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encode.init_layer.0.weight"], c["encode.init_layer.0.weight"])


def test_state_dict_round_trip_from_torch(port_model):
    sd = port_model.state_dict()
    back = hrnet_state_dict_from_flax(hrnet_params_from_torch(sd, num_res_layers=1))
    assert back.keys() == sd.keys()
    for k in sd:
        assert back[k].dtype == sd[k].dtype and torch.equal(back[k], sd[k]), k


def test_state_dict_round_trip_from_flax():
    net = DEFAULT_CONFIG["network"]
    variables = JaxHRNet(config=net).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 8, 8)), jnp.ones((1, 2))
    )
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    sd = hrnet_state_dict_from_flax(params)
    HRNet(net).load_state_dict(sd)  # strict: every key present, every shape right
    back = hrnet_params_from_torch(sd, num_res_layers=net["encoder"]["num_layers"])
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape and np.array_equal(a, b), path


def test_compute_dtypes_map_like_jax():
    from highresnet_tpu.models.hrnet import resolve_compute_dtypes
    from highresnet_tpu_torch.runtime import compute_dtypes

    for name in (None, "float32", "bfloat16", "mixed"):
        want = tuple(jnp.dtype(d).name for d in resolve_compute_dtypes(name))
        got = tuple(str(d).removeprefix("torch.") for d in compute_dtypes(name))
        assert got == want, name
    with pytest.raises(ValueError):
        compute_dtypes("float16")
    body, dec = compute_dtypes("mixed")
    model = HRNet(SMALL_NET, dtype=body, decoder_dtype=dec)
    # parameters stay f32 (cast at use, as in JAX); activations take the dtypes
    assert all(p.dtype == torch.float32 for p in model.parameters())
    seen = {}
    for name in ("encode", "fuse", "decode"):
        getattr(model, name).register_forward_hook(
            lambda m, args, out, name=name: seen.__setitem__(name, out.dtype)
        )
    out = model(torch.rand(1, 4, 6, 6), torch.ones(1, 4))
    assert seen == {"encode": torch.bfloat16, "fuse": torch.bfloat16, "decode": torch.float32}
    assert out.dtype == torch.float32 and out.shape == (1, 18, 18)
