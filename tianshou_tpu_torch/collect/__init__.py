"""The public names of ``tianshou_tpu_torch.collect``, those of ``tianshou_tpu/collect/__init__.py``,
imported from their modules on first use (``utils/lazy.py``)."""

from tianshou_tpu_torch.utils.lazy import lazy_exports

_EXPORTS = {
    "CollectState": "collector",
    "CollectStats": "collector",
    "Collector": "collector",
    "HostCollector": "host_collector",
}
__all__ = sorted(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
