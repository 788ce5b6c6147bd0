"""Device resolution and generator forking shared by the port's entry points.

Every entry point takes ``device`` (default ``"cuda"``) and resolves it here.
Asking for CUDA on a machine without it raises: the port never moves itself
to the CPU.  Random streams are explicit ``torch.Generator``s, the
counterpart of the JAX package's ``jax.random`` keys.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "make_generator", "fork_generator"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if it names CUDA and CUDA is
    absent.

    On CUDA this also pins float32 numerics: cuDNN convolutions and cuBLAS
    matmuls in float32 run in full float32, not TF32
    (``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32`` both False), so float32 paths
    compare with the JAX reference.  bf16 compute is unaffected.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but CUDA is not available; "
                "pass device='cpu' to run on the CPU"
            )
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def make_generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def fork_generator(g: torch.Generator, out: torch.Generator | None = None) -> torch.Generator:
    """A new generator on ``g``'s device seeded from one draw of ``g`` (the
    counterpart of ``jax.random.split``); with ``out``, ``out`` re-seeded
    from that draw instead (the same stream, in a generator that a CUDA
    graph has registered).  Reads the draw on the host, so call it at
    set-up, not inside a superstep."""
    seed = torch.randint(
        0, 2**62, (1,), generator=g, device=g.device, dtype=torch.int64
    )
    if out is None:
        return make_generator(int(seed.item()), g.device)
    out.manual_seed(int(seed.item()))
    return out
