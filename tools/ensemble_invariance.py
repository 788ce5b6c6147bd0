#!/usr/bin/env python3
"""Is a member of an ensemble layer computed the same way whatever the number
of members a batched product holds?

A sharded ``EnsembleMLP`` (``networks/common.py``) holds K / ep members; its
update equals the unsharded one bitwise only if every layer computes a member
alike at K and at K / ep.  This script computes each candidate formulation of
the first layer (a shared ``[B, in]`` input against ``[K, in, out]``) and of a
scalar head (``[K, B, H]`` against ``[K, H, 1]``) at K = 10 and as two halves
of 5, forward and backward, and prints for each output and gradient ``=``
(bitwise equal) or the largest difference.  The input's gradient is compared
as the halves' sum, the way the ranks' shares are summed, so it may differ by
rounding for every formulation.  ``EnsembleMLP`` uses ``baddbmm_expand`` and
``mulsum``.

    python3 tools/ensemble_invariance.py          # on the card
    python3 tools/ensemble_invariance.py --cpu    # a rehearsal on the CPU
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

B, K, HID = 256, 10, 256

FIRST = {
    "matmul": lambda x, w, b: torch.matmul(x, w) + b[:, None, :],
    "baddbmm_expand": lambda x, w, b: torch.baddbmm(b[:, None, :], x.expand(w.shape[0], *x.shape), w),
}
HEAD = {
    "baddbmm": lambda h, w, b: torch.baddbmm(b[:, None, :], h, w),
    "mulsum": lambda h, w, b: (h * w[:, None, :, 0]).sum(-1, keepdim=True) + b[:, None, :],
    "pad32": lambda h, w, b: torch.baddbmm(F.pad(b, (0, 31))[:, None, :], h, F.pad(w, (0, 31)))[..., :1],
}


def _run(fn, a, w, b, gy, members: slice):
    a = (a if a.dim() == 2 else a[members]).detach().clone().requires_grad_(True)
    w = w[members].detach().clone().requires_grad_(True)
    b = b[members].detach().clone().requires_grad_(True)
    y = fn(a, w, b)
    (y * gy[members]).sum().backward()
    return y.detach(), a.grad, w.grad, b.grad


def compare(fn, a, w, b, gy) -> dict[str, str]:
    full = _run(fn, a, w, b, gy, slice(0, K))
    halves = [_run(fn, a, w, b, gy, slice(0, K // 2)), _run(fn, a, w, b, gy, slice(K // 2, K))]
    out = {}
    for i, part in enumerate(("y", "grad_in", "grad_w", "grad_b")):
        shared = part == "grad_in" and a.dim() == 2
        got = halves[0][i] + halves[1][i] if shared else torch.cat([halves[0][i], halves[1][i]])
        out[part] = "=" if torch.equal(got, full[i]) else f"{float((got - full[i]).abs().max()):.3e}"
    return out


def main() -> int:
    if "--cpu" not in sys.argv and not torch.cuda.is_available():
        print("ensemble_invariance: CUDA is not available (pass --cpu for a rehearsal)", file=sys.stderr)
        return 1
    dev = "cpu" if "--cpu" in sys.argv else "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=g) * scale

    x, w0, b0 = rnd(B, 4), rnd(K, 4, HID, scale=0.5), rnd(K, HID, scale=0.1)
    h, w2, b2 = torch.relu(rnd(K, B, HID)), rnd(K, HID, 1, scale=0.06), rnd(K, 1, scale=0.1)
    gy0, gy2 = rnd(K, B, HID), rnd(K, B, 1)
    name = torch.cuda.get_device_name(0) if dev == "cuda" else "cpu"
    print(f"device {name}, K {K} against two halves, B {B}, hidden {HID}, float32 (TF32 off)")
    for label, fn in FIRST.items():
        print(f"first layer {label}: {compare(fn, x, w0, b0, gy0)}")
    for label, fn in HEAD.items():
        print(f"scalar head {label}: {compare(fn, h, w2, b2, gy2)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
