"""The public names of ``tianshou_tpu_torch.data``, those of ``tianshou_tpu/data/__init__.py``,
imported from their modules on first use (``utils/lazy.py``)."""

from tianshou_tpu_torch.utils.lazy import lazy_exports

_EXPORTS = {
    "Batch": "batch",
    "ReplayBuffer": "buffer",
    "ReplayBufferState": "buffer",
    "HERReplayBuffer": "her",
    "PrioritizedReplayBuffer": "prio",
    "PrioritizedReplayBufferState": "prio",
    "InfoStats": "stats",
    "SequenceSummaryStats": "stats",
    "TimingStats": "stats",
}
__all__ = sorted(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
