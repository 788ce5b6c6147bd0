"""The public names of ``tianshou_tpu_torch.algos``, those of ``tianshou_tpu/algos/__init__.py``,
imported from their modules on first use (``utils/lazy.py``)."""

from tianshou_tpu_torch.utils.lazy import lazy_exports

_EXPORTS = {
    "A2C": "a2c",
    "Algorithm": "base",
    "RandomPolicy": "base",
    "TrainState": "base",
    "BDQ": "bdq",
    "C51": "c51",
    "Rainbow": "c51",
    "DDPG": "ddpg",
    "TD3": "ddpg",
    "DQN": "dqn",
    "DRQN": "drqn",
    "GAIL": "gail",
    "ICM": "icm",
    "ICMNet": "icm",
    "MultiAgentPolicyManager": "multiagent",
    "NPG": "npg",
    "TRPO": "npg",
    "BC": "offline",
    "BCQ": "offline",
    "CQL": "offline",
    "TD3BC": "offline",
    "DiscreteBCQ": "offline",
    "DiscreteCQL": "offline",
    "DiscreteCRR": "offline",
    "PG": "pg",
    "PPO": "ppo",
    "PSRL": "psrl",
    "FQF": "qrdqn",
    "IQN": "qrdqn",
    "QRDQN": "qrdqn",
    "REDQ": "redq",
    "SAC": "sac",
    "DiscreteSAC": "sac",
}
__all__ = sorted(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
