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


# NatureCNN's channels-last route in a 16-bit compute dtype (networks/conv.py
# _conv_nhwc): space-to-depth for a strided layer with too few channels.

def _s2d_case(c, k, s, hw, layout):
    """A conv with ``c`` input channels, its float64 input ``[3, c, hw, hw]``
    and that input as ``_to_hwc`` reads it from the given layout."""
    from torch import nn

    g = torch.Generator().manual_seed(4)
    conv = nn.Conv2d(c, 32, k, stride=s).double()
    with torch.no_grad():
        conv.bias.normal_(generator=g)
    x = torch.randn(3, c, hw, hw, dtype=torch.float64, generator=g)
    given = x if layout == "chw" else x.permute(0, 2, 3, 1).contiguous()
    return conv, x, _to_hwc(given, layout)


@pytest.mark.parametrize("c,k,s,hw,layout", [
    (4, 8, 4, 84, "chw"), (4, 8, 4, 84, "hwc"), (4, 8, 4, 87, "chw"), (1, 4, 2, 20, "chw"),
], ids=["nature-chw", "nature-hwc", "unread-edges", "one-channel"])
def test_space_to_depth_conv_matches_conv2d_in_float64(c, k, s, hw, layout):
    from tianshou_tpu_torch.networks.conv import _conv_nhwc, _folds

    conv, x, xh = _s2d_case(c, k, s, hw, layout)
    assert _folds(conv)
    got = _conv_nhwc(xh, conv, torch.float64)
    ref = torch.nn.functional.conv2d(x, conv.weight, conv.bias, stride=s).permute(0, 2, 3, 1)
    assert got.shape == ref.shape and got.is_contiguous()
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-12)
    dy = torch.randn(ref.shape, dtype=torch.float64, generator=torch.Generator().manual_seed(5))
    grads = torch.autograd.grad((got * dy).sum(), [conv.weight, conv.bias])
    refs = torch.autograd.grad((ref * dy).sum(), [conv.weight, conv.bias])
    for g, r in zip(grads, refs):
        assert g.is_contiguous() and g.dtype == torch.float64
        torch.testing.assert_close(g, r, rtol=0, atol=1e-12)


def _nature(compute_dtype, obs_shape=(4, 84, 84)):
    from tianshou_tpu_torch.networks.conv import NatureCNN

    net = NatureCNN(obs_shape, compute_dtype=compute_dtype)
    net.reset_parameters(torch.Generator().manual_seed(6))
    return net


def _frames(obs_shape, n=5):
    return torch.randint(0, 256, (n, *obs_shape), dtype=torch.uint8, generator=torch.Generator().manual_seed(7))


@pytest.mark.parametrize("obs_shape", [(4, 84, 84), (84, 84, 4), (36, 36, 2)], ids=["chw", "hwc", "small"])
def test_bf16_nature_channels_last_matches_the_float32_nchw_route(obs_shape):
    """bf16 compute: 2e-2 of the output scale, as against Flax."""
    net = _nature(torch.bfloat16, obs_shape)
    ref_net = _nature(None, obs_shape)
    ref_net.load_state_dict(net.state_dict())
    x = _frames(obs_shape)
    with torch.no_grad():
        got, ref = net(x), ref_net(x)
    assert got.dtype == torch.float32 and ref.abs().max() > 1e-3
    torch.testing.assert_close(got, ref, rtol=0, atol=2e-2 * float(ref.abs().max()))


def test_bf16_nature_parameters_keep_their_names_shapes_dtypes_and_layout():
    net = _nature(torch.bfloat16)
    before = {k: (tuple(v.shape), v.dtype) for k, v in net.state_dict().items()}
    assert before == {
        "convs.0.weight": ((32, 4, 8, 8), torch.float32), "convs.0.bias": ((32,), torch.float32),
        "convs.1.weight": ((64, 32, 4, 4), torch.float32), "convs.1.bias": ((64,), torch.float32),
        "convs.2.weight": ((64, 64, 3, 3), torch.float32), "convs.2.bias": ((64,), torch.float32),
        "dense.weight": ((512, 3136), torch.float32), "dense.bias": ((512,), torch.float32)}
    params = list(net.parameters())
    grads = torch.autograd.grad(net(_frames((4, 84, 84))).square().sum(), params)
    assert {k: (tuple(v.shape), v.dtype) for k, v in net.state_dict().items()} == before
    for p, g in zip(params, grads):
        assert p.is_contiguous() and g.is_contiguous() and g.dtype == p.dtype and g.shape == p.shape


def test_float32_nature_is_the_nchw_conv2d_chain_bitwise():
    import torch.nn.functional as F

    net = _nature(None)
    x = _frames((4, 84, 84))
    with torch.no_grad():
        got = net(x)
        h = x.to(torch.float32)
        for conv in net.convs:
            h = F.relu(F.conv2d(h, conv.weight, conv.bias, stride=conv.stride))
        ref = F.relu(F.linear(h.permute(0, 2, 3, 1).reshape(5, -1), net.dense.weight, net.dense.bias))
    assert torch.equal(got, ref)


@pytest.mark.parametrize("compute_dtype,expected", [
    (torch.bfloat16, {"s2d_nhwc": 1, "nhwc": 2}), (None, {"nchw": 3}),
], ids=["bf16", "float32"])
def test_conv_route_counts_a_nature_forward(compute_dtype, expected):
    from tianshou_tpu_torch.utils import trace

    from tianshou_tpu_torch.networks.conv import _folds

    net = _nature(compute_dtype, (36, 36, 4))
    assert [_folds(conv) for conv in net.convs] == [True, False, False]
    trace.clear()
    try:
        with torch.no_grad():
            net(_frames((36, 36, 4), n=2))
            net(_frames((36, 36, 4), n=2))
        assert {tag: n for (name, tag), n in trace.counters().items() if name == "conv.route"} == {
            tag: 2 * n for tag, n in expected.items()}
    finally:
        trace.clear()


def test_bf16_conv_q_net_under_vmap_equals_a_loop():
    """``torch.func.vmap`` over ``functional_call`` of a bf16 Nature
    ``ConvQNet``, as TRPO's line search runs it, equals one call per
    perturbation of the parameters, at the bf16 bound of this file: a
    batched convolution rounds in bf16 apart from a single one (2.2e-3 of
    the scale, as the NCHW chain's), while the perturbations move the output
    by 0.17 and 0.62 of it."""
    net = ConvQNet((4, 84, 84), 6)
    net.reset_parameters(torch.Generator().manual_seed(9))
    x = _frames((4, 84, 84), n=3)
    params = {n: p.detach() for n, p in net.named_parameters()}
    g = torch.Generator().manual_seed(10)
    dirs = {n: torch.randn(p.shape, generator=g) for n, p in params.items()}

    def at(frac):
        return torch.func.functional_call(net, {n: p + 0.01 * frac * dirs[n] for n, p in params.items()}, (x,))

    fracs = torch.tensor([0.0, 0.3, 1.0])
    with torch.no_grad():
        got = torch.func.vmap(at)(fracs)
        ref = torch.stack([at(frac) for frac in fracs])
    scale = float(ref.abs().max())
    assert got.shape == (3, 3, 6) and float((ref[1:] - ref[0]).abs().amax((1, 2)).min()) > 0.1 * scale
    torch.testing.assert_close(got, ref, rtol=0, atol=2e-2 * scale)


def test_pixel_trpo_learns_once():
    """One TRPO learn with the networks the high-level factories give an
    84x84 pixel env: a bf16 Nature actor through the natural gradient's
    double backward and the line search's vmap."""
    from tianshou_tpu_torch.algos.npg import TRPO
    from tianshou_tpu_torch.data.batch import Batch
    from tianshou_tpu_torch.envs.synthetic import SyntheticPixelEnv
    from tianshou_tpu_torch.highlevel.env import Environments
    from tianshou_tpu_torch.highlevel.module import default_actor, default_value_network
    from tianshou_tpu_torch.networks.conv import NatureCNN

    env = SyntheticPixelEnv(84, 84, 4)
    envs = Environments(None, None, env.observation_space, env.action_space, "torch")
    algo = TRPO(default_actor(envs), default_value_network(envs), env.action_space, device="cpu")
    assert isinstance(algo.actor.encoder, NatureCNN) and algo.actor.input_dtype == torch.bfloat16
    ts = algo.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(11)
    n = 8
    obs = torch.randint(0, 256, (n, 84, 84, 4), dtype=torch.uint8, generator=g)
    act = torch.randint(0, env.action_space.n, (n,), generator=g)
    with torch.no_grad():
        logp, _ = algo._log_prob_entropy(ts.actor(obs), act)
    ret = torch.randn(n, generator=g) * 2
    mb = Batch(obs=obs, act=act, ret=ret, v_s=ret + torch.randn(n, generator=g) * 0.5,
               adv=torch.randn(n, generator=g) * 2 + 0.3, logp_old=logp + torch.randn(n, generator=g) * 0.3)
    before = {k: v.clone() for k, v in ts.actor.state_dict().items()}
    ts, metrics = algo.learn(ts, mb)
    assert set(metrics) == {"value_loss", "accepted", "kl"}
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    moved = any(not torch.equal(v, ts.actor.state_dict()[k]) for k, v in before.items())
    assert moved == bool(metrics["accepted"])
    if moved:
        assert float(metrics["kl"]) < algo.max_kl
