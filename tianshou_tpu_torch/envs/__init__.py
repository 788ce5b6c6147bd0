"""The public names of ``tianshou_tpu_torch.envs``, those of ``tianshou_tpu/envs/__init__.py``
(``TorchEnv`` for ``JaxEnv``), imported from their modules on first use (``utils/lazy.py``)."""

from tianshou_tpu_torch.utils.lazy import lazy_exports

_EXPORTS = {
    "TorchEnv": "base",
    "StepResult": "base",
    "VectorEnv": "base",
    "make_env": "classic",
    "FiniteHostVectorEnv": "finite",
    "collect_dataset_episodes": "finite",
    "make_minatar": "minatar",
    "NormObsVectorEnv": "norm",
    "Box": "spaces",
    "Discrete": "spaces",
    "MultiDiscrete": "spaces",
}
__all__ = sorted(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
