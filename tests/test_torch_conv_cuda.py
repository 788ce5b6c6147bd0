"""NatureCNN's bf16 convolutions on the card (tianshou_tpu_torch/networks/conv.py):
a forward and backward at batch 512, the replay update's shape, launches no
float32 convolution (``implicit_gemm`` with ``f32f32``) and none of cuDNN's
layout or dtype conversions (``nchwToNhwc``, ``nhwcToNchw``,
``convertTensor``); every float32 GEMM it still launches (``sgemm``,
``f32f32``) is one that the float32 head's forward and backward alone
launch; and its Q-values agree with the NCHW bf16 chain and the float32
encoder at 2e-2 of the output scale.  The card's kernels are printed
(``-s``).  TRPO's line search, ``torch.func.vmap`` over ``functional_call``
of such a net, agrees with a loop at the same bound, and one TRPO learn
with a bf16 Nature actor runs.

Skipped without CUDA; on a card: ``python3 -m pytest --noconftest -q -s
tests/test_torch_conv_cuda.py -m cuda``.  Imports no JAX.
"""

import pytest
import torch
import torch.nn.functional as F

from tianshou_tpu_torch.networks.conv import ConvQNet
from tianshou_tpu_torch.utils.device import resolve_device

CONVERSIONS = ("nchwToNhwc", "nhwcToNchw", "convertTensor")


def _kernels(step) -> list[str]:
    """The names of the kernels ``step()`` launches, after one warm-up call
    (cuDNN's and cuBLAS's engine choice)."""
    step()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA})


def _float32_gemm(name: str) -> bool:
    return "sgemm" in name or ("f32f32" in name and "implicit_gemm" not in name)


def _nchw_bf16(net: ConvQNet, x: torch.Tensor) -> torch.Tensor:
    """The encoder as NCHW bf16 ``F.conv2d`` calls, then the float32 head."""
    dt, enc = torch.bfloat16, net.encoder
    h = x.to(dt)
    for conv in enc.convs:
        h = F.relu(F.conv2d(h, conv.weight.to(dt), conv.bias.to(dt), stride=conv.stride))
    h = F.relu(F.linear(h.permute(0, 2, 3, 1).reshape(h.shape[0], -1), enc.dense.weight.to(dt), enc.dense.bias.to(dt)))
    return net.head(h.to(torch.float32))


@pytest.mark.cuda
def test_bf16_nature_forward_and_backward_launch_no_conversion():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    device = resolve_device("cuda")
    g = torch.Generator(device=device).manual_seed(0)
    net = ConvQNet((4, 84, 84), 6, encoder_kwargs={"compute_dtype": torch.bfloat16}).to(device)
    net.reset_parameters(g)
    # the presample's bf16 stacks
    x = torch.randint(0, 256, (512, 4, 84, 84), generator=g, device=device, dtype=torch.uint8).to(torch.bfloat16)
    params = list(net.parameters())

    def step():
        q = net(x)
        return q, torch.autograd.grad(q.square().mean(), params)

    kernels = _kernels(step)
    print("\n".join(["kernels:", *kernels]))
    assert kernels
    assert [k for k in kernels if "implicit_gemm" in k and "f32f32" in k] == []
    assert [k for k in kernels if any(c in k for c in CONVERSIONS)] == []
    feat = torch.randn((512, 512), generator=g, device=device, requires_grad=True)
    head = [feat, *net.head.parameters()]
    head_kernels = _kernels(lambda: torch.autograd.grad(net.head(feat).square().mean(), head))
    print("\n".join(["float32 GEMMs, all the head's:", *filter(_float32_gemm, kernels)]))
    assert set(filter(_float32_gemm, kernels)) <= set(head_kernels)

    q, grads = step()
    assert all(gr.is_contiguous() and gr.dtype == torch.float32 for gr in grads)

    with torch.no_grad():
        ref = _nchw_bf16(net, x)
        net32 = ConvQNet((4, 84, 84), 6, encoder_kwargs={"compute_dtype": None}).to(device)
        net32.load_state_dict(net.state_dict())
        ref32 = net32(x)
    for r in (ref, ref32):
        torch.testing.assert_close(q, r, rtol=0, atol=2e-2 * float(r.abs().max()))


@pytest.mark.cuda
def test_bf16_nature_under_vmap_and_a_pixel_trpo_learn():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from tianshou_tpu_torch.algos.npg import TRPO
    from tianshou_tpu_torch.data.batch import Batch
    from tianshou_tpu_torch.envs.spaces import Discrete
    from tianshou_tpu_torch.networks.conv import ConvValueNet

    device = resolve_device("cuda")
    g = torch.Generator(device=device).manual_seed(1)
    net = ConvQNet((4, 84, 84), 6).to(device)
    net.reset_parameters(g)
    x = torch.randint(0, 256, (64, 4, 84, 84), generator=g, device=device, dtype=torch.uint8)
    params = {n: p.detach() for n, p in net.named_parameters()}
    dirs = {n: torch.randn(p.shape, generator=g, device=device) for n, p in params.items()}

    def at(frac):
        return torch.func.functional_call(net, {n: p + 0.01 * frac * dirs[n] for n, p in params.items()}, (x,))

    fracs = torch.tensor([0.0, 0.3, 1.0], device=device)
    with torch.no_grad():
        got = torch.func.vmap(at)(fracs)
        ref = torch.stack([at(frac) for frac in fracs])
    scale = float(ref.abs().max())
    print(f"vmap against a loop: {float((got - ref).abs().max()) / scale:.3e} of the scale")
    torch.testing.assert_close(got, ref, rtol=0, atol=2e-2 * scale)

    algo = TRPO(ConvQNet((4, 84, 84), 6), ConvValueNet((4, 84, 84), encoder="nature"), Discrete(6), device=device)
    ts = algo.init(torch.Generator(device=device).manual_seed(0))
    act = torch.randint(0, 6, (64,), generator=g, device=device)
    with torch.no_grad():
        logp, _ = algo._log_prob_entropy(ts.actor(x), act)
    noise = torch.randn((3, 64), generator=g, device=device)
    mb = Batch(obs=x, act=act, ret=noise[0] * 2, v_s=noise[0] * 2 + 0.5 * noise[1], adv=noise[1] * 2 + 0.3,
               logp_old=logp + 0.3 * noise[2])
    ts, metrics = algo.learn(ts, mb)
    print("pixel TRPO learn:", {k: float(v) for k, v in metrics.items()})
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
