"""The public names of ``tianshou_tpu_torch.trainer``, those of ``tianshou_tpu/trainer/__init__.py``,
imported from their modules on first use (``utils/lazy.py``)."""

from tianshou_tpu_torch.utils.lazy import lazy_exports

_EXPORTS = {
    "OfflineTrainer": "offline",
    "OffPolicyTrainer": "offpolicy",
    "OnPolicyTrainer": "onpolicy",
}
__all__ = sorted(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
