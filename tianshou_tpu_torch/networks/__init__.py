"""The public names of ``tianshou_tpu_torch.networks``, those of ``tianshou_tpu/networks/__init__.py``,
imported from their modules on first use (``utils/lazy.py``)."""

from tianshou_tpu_torch.utils.lazy import lazy_exports

_EXPORTS = {
    "ConvDuelingQNet": "conv",
    "ConvQNet": "conv",
    "MinAtarCNN": "conv",
    "NatureCNN": "conv",
}
__all__ = sorted(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
