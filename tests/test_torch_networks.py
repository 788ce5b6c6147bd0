"""ConvQNet(nature) port (tianshou_tpu_torch/networks) against Flax after
params_from_flax, in HWC and CHW layouts.  float32 compute: atol 1e-4 (the
two frameworks sum the convolutions in different orders).  bf16 compute:
rtol 2e-2 of the output scale (bf16 rounds at different points in XLA and
in PyTorch)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.networks.conv import ConvQNet as JaxConvQNet
from tianshou_tpu_torch.networks.conv import ConvQNet, _to_hwc
from tianshou_tpu_torch.networks.convert import params_from_flax

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(obs_shape, dtype, seed=0, num_actions=4):
    jdt, tdt = DTYPES[dtype]
    jnet = JaxConvQNet(num_actions=num_actions, encoder="nature", encoder_kwargs={"compute_dtype": jdt})
    params = jnet.init(jax.random.key(seed), jnp.zeros((1, *obs_shape), jnp.uint8))
    tnet = ConvQNet(obs_shape, num_actions, encoder_kwargs={"compute_dtype": tdt})
    tnet.load_state_dict(params_from_flax(jax.device_get(params)))
    return jnet, params, tnet


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("obs_shape", [(36, 36, 2), (2, 36, 36), (44, 40, 3)], ids=["hwc", "chw", "hwc-rect"])
def test_conv_q_net_forward_matches_flax(obs_shape, dtype):
    jnet, params, tnet = _pair(obs_shape, dtype)
    x = np.random.default_rng(1).integers(0, 256, (5, *obs_shape), dtype=np.uint8)
    ref = np.asarray(jnet.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tnet(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == ref.shape == (5, 4)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-2 * np.abs(ref).max())


def test_params_from_flax_shapes_at_atari_width():
    params = jax.eval_shape(
        JaxConvQNet(num_actions=6, encoder="nature").init, jax.random.key(0), jnp.zeros((1, 84, 84, 4), jnp.uint8)
    )
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), params)
    sd = params_from_flax(zeros)
    tnet = ConvQNet((84, 84, 4), 6)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape) for k, v in tnet.state_dict().items()}
    assert tuple(sd["encoder.dense.weight"].shape) == (512, 3136)
    assert tnet.input_dtype == torch.bfloat16


def test_init_follows_flax_defaults():
    net = ConvQNet((84, 84, 4), 6)
    net.reset_parameters(torch.Generator().manual_seed(0))
    for name, p in net.state_dict().items():
        if name.endswith("bias"):
            assert torch.count_nonzero(p) == 0
        else:
            fan_in = p[0].numel()
            # lecun normal: variance 1/fan_in, truncated at two (pre-truncation) stddevs
            std = (1.0 / fan_in) ** 0.5
            assert abs(float(p.std()) / std - 1.0) < 0.1, name
            assert float(p.abs().max()) <= 2.0 * std / 0.87962566103423978 + 1e-6


@pytest.mark.parametrize("shape,layout,expected", [
    ((2, 7, 9, 3), "auto", (2, 7, 9, 3)),
    ((2, 3, 9, 10), "auto", (2, 9, 10, 3)),
    ((2, 3, 9, 10), "hwc", (2, 3, 9, 10)),
    ((2, 4, 9, 10, 3), "auto", (2, 9, 10, 12)),
])
def test_to_hwc_matches_jax(shape, layout, expected):
    from tianshou_tpu.networks.conv import _to_hwc as jax_to_hwc

    x = np.arange(np.prod(shape)).reshape(shape).astype(np.int32)
    ref = np.asarray(jax_to_hwc(jnp.asarray(x), layout))
    got = _to_hwc(torch.from_numpy(x), layout).numpy()
    assert got.shape == expected
    np.testing.assert_array_equal(got, ref)


def _flax_and_port(name, dtype, obs_shape):
    """A Flax net, its parameters, and the port's counterpart carrying them."""
    from tianshou_tpu.networks import common as jcommon
    from tianshou_tpu.networks import conv as jconv
    from tianshou_tpu_torch.networks import common, conv

    jdt, tdt = DTYPES[dtype]
    hidden = (32, 16)
    enc = {"compute_dtype": jdt}, {"compute_dtype": tdt}
    pairs = {
        "MLP": lambda: (jcommon.MLP(hidden, 5, compute_dtype=jdt), common.MLP(obs_shape, hidden, 5, compute_dtype=tdt)),
        "MLP-features": lambda: (jcommon.MLP(hidden, None, compute_dtype=jdt),
                                 common.MLP(obs_shape, hidden, None, compute_dtype=tdt)),
        "QNet": lambda: (jcommon.QNet(hidden, 3, compute_dtype=jdt),
                         common.QNet(obs_shape, hidden, 3, compute_dtype=tdt)),
        "DuelingQNet": lambda: (jcommon.DuelingQNet(hidden, 3, compute_dtype=jdt),
                                common.DuelingQNet(obs_shape, hidden, 3, compute_dtype=tdt)),
        "MinAtarCNN": lambda: (jconv.MinAtarCNN(compute_dtype=jdt), conv.MinAtarCNN(obs_shape, compute_dtype=tdt)),
        "ConvQNet": lambda: (jconv.ConvQNet(3, "minatar", enc[0]), conv.ConvQNet(obs_shape, 3, "minatar", enc[1])),
        "ConvValueNet": lambda: (jconv.ConvValueNet("minatar", enc[0]),
                                 conv.ConvValueNet(obs_shape, "minatar", enc[1])),
        "ConvDuelingQNet": lambda: (jconv.ConvDuelingQNet(3, "minatar", enc[0]),
                                    conv.ConvDuelingQNet(obs_shape, 3, "minatar", enc[1])),
    }
    jnet, tnet = pairs[name]()
    params = jnet.init(jax.random.key(3), jnp.zeros((1, *obs_shape), jnp.float32))
    tnet.load_state_dict(params_from_flax(jax.device_get(params)))
    return jnet, params, tnet


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,obs_shape", [
    ("MLP", (4,)), ("MLP-features", (3, 2)), ("QNet", (4,)), ("DuelingQNet", (6,)),
    ("MinAtarCNN", (10, 10, 4)), ("ConvQNet", (10, 10, 4)), ("ConvValueNet", (10, 10, 4)),
    ("ConvDuelingQNet", (10, 10, 4)),
])
def test_slice2_forwards_match_flax(name, obs_shape, dtype):
    """float32: atol 1e-5 for the MLPs, 1e-4 for the convs; bf16 compute:
    2e-2 of the output scale."""
    jnet, params, tnet = _flax_and_port(name, dtype, obs_shape)
    x = np.random.default_rng(2).random((7, *obs_shape)).astype(np.float32)
    if len(obs_shape) == 3:
        x = (x < 0.3).astype(np.float32)  # MinAtar's one-hot planes
    ref = np.asarray(jnet.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tnet(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert np.abs(ref).max() > 1e-3
    if dtype == "float32":
        atol = 1e-4 if len(obs_shape) == 3 else 1e-5
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=atol)
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-2 * np.abs(ref).max())


def test_minatar_cnn_keeps_the_grid_size():
    from tianshou_tpu_torch.networks.conv import MinAtarCNN

    net = MinAtarCNN((10, 10, 4), compute_dtype=None)
    assert net.convs[0].padding == (1, 1)
    assert tuple(net.dense.weight.shape) == (128, 10 * 10 * 16)
    assert net(torch.zeros(2, 10, 10, 4)).shape == (2, 128)


def test_mlp_init_is_orthogonal():
    from tianshou_tpu_torch.networks.common import MLP

    net = MLP((4,), (128, 128, 64), 2)
    net.reset_parameters(torch.Generator().manual_seed(0))
    layers = list(net.layers)
    for i, layer in enumerate(layers):
        w = layer.weight.detach().double()
        gain2 = 1.0 if i == len(layers) - 1 else 2.0
        # W W^T = g^2 I over the smaller side of [out, in]
        gram = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
        torch.testing.assert_close(gram, gain2 * torch.eye(gram.shape[0], dtype=torch.float64), rtol=0, atol=1e-5)
        assert torch.count_nonzero(layer.bias) == 0
