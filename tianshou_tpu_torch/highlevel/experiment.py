"""High-level declarative experiment API (port of
``tianshou_tpu/highlevel/experiment.py``).

An :class:`Experiment` is configuration only (it pickles): an env factory,
an algorithm factory and a sampling config.  ``run()`` builds the envs,
buffer, algorithm, collectors, trainer and logger on
``ExperimentConfig.device`` (``"cuda"`` by default; without CUDA it raises
unless the config asks for ``"cpu"``), trains, and saves the experiment and
its best checkpoint under the log directory when it logs to tensorboard.
The builders give the fluent ``with_*`` construction surface, with one
parameter dataclass per algorithm.

A pickled experiment holds the device as its string and no tensor.
``save`` uses cloudpickle where it is installed, as the JAX package does:
a builder sets ``config.train_param_fn`` to a lambda, which plain pickle
cannot write.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import time
from collections.abc import Callable
from typing import Any, Literal

import numpy as np
import torch

from tianshou_tpu_torch.algos.base import Algorithm
from tianshou_tpu_torch.collect.collector import Collector
from tianshou_tpu_torch.collect.host_collector import HostCollector
from tianshou_tpu_torch.data.buffer import ReplayBuffer
from tianshou_tpu_torch.data.prio import PrioritizedReplayBuffer
from tianshou_tpu_torch.data.stats import InfoStats
from tianshou_tpu_torch.envs.spaces import Box, Discrete
from tianshou_tpu_torch.highlevel.config import SamplingConfig
from tianshou_tpu_torch.highlevel.env import EnvFactory, Environments
from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer
from tianshou_tpu_torch.trainer.onpolicy import OnPolicyTrainer
from tianshou_tpu_torch.utils.checkpoint import save_checkpoint
from tianshou_tpu_torch.utils.device import make_generator, resolve_device
from tianshou_tpu_torch.utils.logger import BaseLogger, LazyLogger, TensorboardLogger
from tianshou_tpu_torch.utils.repr import ToStringMixin

__all__ = [
    "ExperimentConfig",
    "World",
    "ExperimentResult",
    "Experiment",
    "ExperimentBuilder",
    "BCExperimentBuilder",
    "CQLExperimentBuilder",
    "TD3BCExperimentBuilder",
    "DQNExperimentBuilder",
    "PPOExperimentBuilder",
    "SACExperimentBuilder",
    "TD3ExperimentBuilder",
    "DDPGExperimentBuilder",
    "A2CExperimentBuilder",
    "PGExperimentBuilder",
    "NPGExperimentBuilder",
    "TRPOExperimentBuilder",
    "IQNExperimentBuilder",
    "REDQExperimentBuilder",
    "DiscreteSACExperimentBuilder",
    "REDQParams",
    "DQNParams",
    "IQNParams",
    "OnPolicyParams",
    "PPOParams",
    "PGParams",
    "NPGParams",
    "TRPOParams",
    "SACParams",
    "DiscreteSACParams",
    "TD3Params",
    "DDPGParams",
    "BCParams",
    "CQLParams",
    "TD3BCParams",
]


@dataclasses.dataclass
class ExperimentConfig:
    """Global experiment settings; ``device`` is where ``run()`` builds
    everything."""

    seed: int = 0
    persistence_base_dir: str = "log"
    logger: Literal["tensorboard", "none"] = "none"
    checkpoint_best: bool = True
    train_param_fn: Callable[[int, int], float] | None = None
    test_param: float = 0.0
    stop_fn: Callable[[float], bool] | None = None
    # after training, replay the trained policy greedily on the test envs
    # and report the returns
    watch: bool = False
    watch_num_episodes: int = 10
    device: str = "cuda"


@dataclasses.dataclass
class World:
    """Everything one run built, for callbacks and post-hoc inspection."""

    envs: Environments
    algo: Algorithm
    trainer: Any
    logger: Any
    log_dir: str | None


@dataclasses.dataclass
class ExperimentResult:
    info: InfoStats
    train_state: Any
    log_dir: str | None
    world: World | None = None
    watch_stats: Any = None


class Experiment(ToStringMixin):
    """A pickle-able experiment: config and factories.  Its repr renders the
    whole declarative configuration."""

    def __init__(
        self,
        config: ExperimentConfig,
        env_factory: EnvFactory,
        algo_factory: Callable[[Environments, str], Algorithm],
        sampling: SamplingConfig,
        trainer_kind: Literal["onpolicy", "offpolicy", "offline"],
        offline_data_path: str | None = None,
    ):
        self.config = config
        self.env_factory = env_factory
        self.algo_factory = algo_factory
        self.sampling = sampling
        self.trainer_kind = trainer_kind
        self.offline_data_path = offline_data_path

    # -- persistence ---------------------------------------------------------
    def save(self, directory: str) -> None:
        """Write the experiment to ``directory/experiment.pkl``, with
        cloudpickle where it is installed, so that lambda callbacks
        survive."""
        os.makedirs(directory, exist_ok=True)
        try:
            import cloudpickle as pickler
        except ImportError:
            pickler = pickle
        with open(os.path.join(directory, "experiment.pkl"), "wb") as f:
            pickler.dump(self, f)

    @staticmethod
    def from_directory(directory: str) -> Experiment:
        with open(os.path.join(directory, "experiment.pkl"), "rb") as f:
            return pickle.load(f)

    # -- orchestration -------------------------------------------------------
    def build_world(
        self,
        name: str | None = None,
        *,
        logger: BaseLogger | None = None,
        resume_from_log: bool = False,
        profile_dir: str | None = None,
    ) -> World:
        """Build everything ``run`` trains, on ``config.device``, without
        training.  ``logger`` replaces the one ``config.logger`` names;
        ``resume_from_log`` continues from the counters the logger saved;
        ``profile_dir`` traces the run (off-policy and on-policy trainers)."""
        cfg, sampling = self.config, self.sampling
        device = cfg.device
        resolve_device(device)  # no CUDA and no "cpu" asked for: raise before building anything
        np.random.seed(cfg.seed)
        torch.manual_seed(cfg.seed)
        name = name or f"exp_{int(time.time())}"
        log_dir = os.path.join(cfg.persistence_base_dir, name) if cfg.logger == "tensorboard" else None
        if logger is None:
            logger = TensorboardLogger(log_dir, train_interval=1000) if log_dir is not None else LazyLogger()

        envs = self.env_factory.create_envs(sampling.num_train_envs, sampling.num_test_envs, device=device)
        algo = self.algo_factory(envs, device)
        on_device = envs.backend == "torch"

        save_best_fn = None
        if cfg.checkpoint_best and log_dir is not None:
            ckpt_dir = os.path.join(log_dir, "checkpoint")

            def save_best_fn(ts):
                save_checkpoint(ckpt_dir, ts)

        def collector(venv, buffer=None):
            cls = Collector if on_device else HostCollector
            return cls(algo, venv, buffer, device=device)

        if self.trainer_kind == "offline":
            # the package's own HDF5, the reference library's layout or a
            # D4RL dataset (HDF5 or .npz)
            from tianshou_tpu_torch.data.persistence import load_any_buffer
            from tianshou_tpu_torch.trainer.offline import OfflineTrainer

            assert self.offline_data_path is not None
            buffer, bstate = load_any_buffer(self.offline_data_path, device=device)
            trainer = OfflineTrainer(
                algo,
                buffer,
                bstate,
                collector(envs.test_venv),
                max_epoch=sampling.num_epochs,
                update_per_epoch=sampling.step_per_epoch,
                batch_size=sampling.batch_size,
                episode_per_test=sampling.episode_per_test,
                stop_fn=cfg.stop_fn,
                logger=logger,
                seed=cfg.seed,
                save_best_fn=save_best_fn,
                device=device,
            )
        elif self.trainer_kind == "offpolicy":
            buf_cls = PrioritizedReplayBuffer if sampling.prioritized_buffer else ReplayBuffer
            buf_kwargs = (
                {"alpha": sampling.prio_alpha, "beta": sampling.prio_beta} if sampling.prioritized_buffer else {}
            )
            buffer = buf_cls(
                capacity=max(1, sampling.buffer_size // sampling.num_train_envs),
                num_envs=sampling.num_train_envs,
                stack_num=sampling.replay_buffer_stack_num,
                **buf_kwargs,
            )
            trainer = OffPolicyTrainer(
                algo,
                collector(envs.train_venv, buffer),
                collector(envs.test_venv),
                buffer,
                max_epoch=sampling.num_epochs,
                step_per_epoch=sampling.step_per_epoch,
                step_per_collect=sampling.step_per_collect,
                update_per_step=sampling.update_per_step,
                batch_size=sampling.batch_size,
                episode_per_test=sampling.episode_per_test,
                train_param_fn=cfg.train_param_fn,
                test_param=cfg.test_param,
                stop_fn=cfg.stop_fn,
                warmup_steps=sampling.start_timesteps,
                warmup_random=sampling.start_timesteps_random,
                logger=logger,
                seed=cfg.seed,
                save_best_fn=save_best_fn,
                resume_from_log=resume_from_log,
                profile_dir=profile_dir,
                device=device,
            )
        else:
            trainer = OnPolicyTrainer(
                algo,
                collector(envs.train_venv),
                collector(envs.test_venv),
                max_epoch=sampling.num_epochs,
                step_per_epoch=sampling.step_per_epoch,
                step_per_collect=sampling.step_per_collect,
                repeat_per_collect=sampling.repeat_per_collect,
                batch_size=sampling.batch_size,
                episode_per_test=sampling.episode_per_test,
                stop_fn=cfg.stop_fn,
                logger=logger,
                seed=cfg.seed,
                save_best_fn=save_best_fn,
                resume_from_log=resume_from_log,
                profile_dir=profile_dir,
                device=device,
            )

        return World(envs=envs, algo=algo, trainer=trainer, logger=logger, log_dir=log_dir)

    def run(self, name: str | None = None, **world_kwargs) -> ExperimentResult:
        """Build the world (:meth:`build_world`, which takes the keyword
        arguments) and train; then the watch episodes, and the experiment
        saved beside its logs."""
        cfg = self.config
        world = self.build_world(name, **world_kwargs)
        trainer, logger, log_dir = world.trainer, world.logger, world.log_dir
        info = trainer.run()

        # greedy episodes of the trained policy on the test envs
        watch_stats = None
        if cfg.watch:
            watch_stats = trainer.test_collector.collect_episodes(
                trainer.train_state,
                make_generator(cfg.seed + 999, resolve_device(cfg.device)),
                cfg.watch_num_episodes,
                explore=False,
            )
            print(
                f"[watch] {cfg.watch_num_episodes} episodes: "
                f"reward {watch_stats.returns_mean:.2f} ± {watch_stats.returns_std:.2f}, "
                f"length {watch_stats.lens_mean:.1f}"
            )

        logger.finalize()
        if log_dir is not None:
            self.save(log_dir)
        return ExperimentResult(
            info=info, train_state=trainer.train_state, log_dir=log_dir, world=world, watch_stats=watch_stats
        )


# ---------------------------------------------------------------------------
# builders


class ExperimentBuilder:
    """Fluent construction of an :class:`Experiment`."""

    trainer_kind: Literal["onpolicy", "offpolicy", "offline"] = "offpolicy"

    def __init__(
        self,
        env_factory: EnvFactory,
        config: ExperimentConfig | None = None,
        sampling: SamplingConfig | None = None,
    ):
        self.env_factory = env_factory
        self.config = config or ExperimentConfig()
        self.sampling = sampling or SamplingConfig()

    def with_seed(self, seed: int):
        self.config.seed = seed
        return self

    def with_logger(self, kind: Literal["tensorboard", "none"]):
        self.config.logger = kind
        return self

    def with_stop_fn(self, fn: Callable[[float], bool]):
        self.config.stop_fn = fn
        return self

    def _make_algo(self, envs: Environments, device: str | None = None) -> Algorithm:
        """The algorithm for ``envs`` on ``device`` (default: the config's)."""
        raise NotImplementedError

    def build(self) -> Experiment:
        return Experiment(
            config=self.config,
            env_factory=self.env_factory,
            algo_factory=self._make_algo,
            sampling=self.sampling,
            trainer_kind=self.trainer_kind,
            offline_data_path=getattr(self, "offline_data_path", None),
        )

    def with_offline_data(self, path: str):
        """The dataset of an offline builder (HDF5, or a D4RL ``.npz``)."""
        self.offline_data_path = path
        return self

    def with_params(self, params):
        """The builder's algorithm-params dataclass."""
        self.params = params
        return self

    def build_seeded_collection(self, num_seeds: int) -> list[Experiment]:
        """Experiments that differ only in their seed."""
        return [
            Experiment(
                config=dataclasses.replace(self.config, seed=self.config.seed + i),
                env_factory=self.env_factory,
                algo_factory=self._make_algo,
                sampling=self.sampling,
                trainer_kind=self.trainer_kind,
            )
            for i in range(num_seeds)
        ]

    def _device(self, device: str | None) -> str:
        return self.config.device if device is None else str(device)


def _shape(envs: Environments) -> tuple[int, ...]:
    return envs.observation_space.shape


def _act_dim(envs: Environments) -> int:
    return envs.action_space.shape[0]


@dataclasses.dataclass
class DQNParams:
    hidden_sizes: tuple[int, ...] = (128, 128)
    lr: float = 1e-3
    gamma: float = 0.99
    n_step: int = 3
    target_update_freq: int = 320
    is_double: bool = True
    dueling: bool = False
    eps_train: float = 0.1
    eps_test: float = 0.0


class DQNExperimentBuilder(ExperimentBuilder):
    trainer_kind = "offpolicy"

    def with_dqn_params(self, params: DQNParams):
        return self.with_params(params)

    def _make_algo(self, envs: Environments, device: str | None = None) -> Algorithm:
        from tianshou_tpu_torch.algos.dqn import DQN
        from tianshou_tpu_torch.highlevel.module import default_q_network

        p = getattr(self, "params", DQNParams())
        assert isinstance(envs.action_space, Discrete)
        self.config.train_param_fn = self.config.train_param_fn or (lambda e, s: p.eps_train)
        self.config.test_param = p.eps_test
        return DQN(
            # the env decides the default net: an MLP for flat obs, conv for pixels
            network=default_q_network(envs, p.hidden_sizes, dueling=p.dueling),
            action_space=envs.action_space,
            lr=p.lr,
            gamma=p.gamma,
            n_step=p.n_step,
            target_update_freq=p.target_update_freq,
            is_double=p.is_double,
            device=self._device(device),
        )


@dataclasses.dataclass
class IQNParams(DQNParams):
    sample_size: int = 32
    online_sample_size: int = 8
    target_sample_size: int = 8


class IQNExperimentBuilder(DQNExperimentBuilder):
    def _make_algo(self, envs: Environments, device: str | None = None) -> Algorithm:
        from tianshou_tpu_torch.algos.qrdqn import IQN
        from tianshou_tpu_torch.networks.discrete import ImplicitQuantileNetwork

        p = getattr(self, "params", IQNParams())
        self.config.train_param_fn = self.config.train_param_fn or (lambda e, s: p.eps_train)
        return IQN(
            ImplicitQuantileNetwork(_shape(envs), p.hidden_sizes, envs.action_space.n),
            envs.action_space,
            sample_size=p.sample_size,
            online_sample_size=p.online_sample_size,
            target_sample_size=p.target_sample_size,
            lr=p.lr,
            gamma=p.gamma,
            n_step=p.n_step,
            target_update_freq=p.target_update_freq,
            device=self._device(device),
        )


@dataclasses.dataclass
class OnPolicyParams:
    hidden_sizes: tuple[int, ...] = (64, 64)
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    vf_coef: float = 0.5
    ent_coef: float = 0.0
    max_grad_norm: float = 0.5


@dataclasses.dataclass
class PPOParams(OnPolicyParams):
    eps_clip: float = 0.2
    value_clip: bool = False
    dual_clip: float | None = None
    adv_norm: bool = True
    recompute_advantage: bool = False


def _make_actor_critic(envs: Environments, hidden_sizes):
    from tianshou_tpu_torch.highlevel.module import default_actor, default_value_network

    return default_actor(envs, hidden_sizes), default_value_network(envs, hidden_sizes)


class PPOExperimentBuilder(ExperimentBuilder):
    trainer_kind = "onpolicy"

    def with_ppo_params(self, params: PPOParams):
        return self.with_params(params)

    def _make_algo(self, envs: Environments, device: str | None = None) -> Algorithm:
        from tianshou_tpu_torch.algos.ppo import PPO

        p = getattr(self, "params", PPOParams())
        actor, critic = _make_actor_critic(envs, p.hidden_sizes)
        return PPO(
            actor, critic, envs.action_space,
            lr=p.lr, gamma=p.gamma, gae_lambda=p.gae_lambda,
            vf_coef=p.vf_coef, ent_coef=p.ent_coef,
            max_grad_norm=p.max_grad_norm, eps_clip=p.eps_clip,
            value_clip=p.value_clip, dual_clip=p.dual_clip,
            adv_norm=p.adv_norm, recompute_advantage=p.recompute_advantage,
            device=self._device(device),
        )


class A2CExperimentBuilder(ExperimentBuilder):
    trainer_kind = "onpolicy"

    def with_a2c_params(self, params: OnPolicyParams):
        return self.with_params(params)

    def _make_algo(self, envs: Environments, device: str | None = None) -> Algorithm:
        from tianshou_tpu_torch.algos.a2c import A2C

        p = getattr(self, "params", OnPolicyParams(lr=7e-4, ent_coef=0.01))
        actor, critic = _make_actor_critic(envs, p.hidden_sizes)
        return A2C(
            actor, critic, envs.action_space,
            lr=p.lr, gamma=p.gamma, gae_lambda=p.gae_lambda,
            vf_coef=p.vf_coef, ent_coef=p.ent_coef,
            max_grad_norm=p.max_grad_norm,
            device=self._device(device),
        )


@dataclasses.dataclass
class PGParams:
    hidden_sizes: tuple[int, ...] = (64, 64)
    lr: float = 3e-4
    gamma: float = 0.99
    ret_norm: bool = True
    ent_coef: float = 0.0


class PGExperimentBuilder(ExperimentBuilder):
    trainer_kind = "onpolicy"

    def _make_algo(self, envs: Environments, device: str | None = None) -> Algorithm:
        from tianshou_tpu_torch.algos.pg import PG
        from tianshou_tpu_torch.networks.common import QNet
        from tianshou_tpu_torch.networks.continuous import GaussianActor

        p = getattr(self, "params", PGParams())
        if isinstance(envs.action_space, Discrete):
            actor = QNet(_shape(envs), p.hidden_sizes, envs.action_space.n)
        else:
            actor = GaussianActor(_shape(envs), p.hidden_sizes, _act_dim(envs))
        return PG(
            actor, envs.action_space, lr=p.lr, gamma=p.gamma,
            ret_norm=p.ret_norm, ent_coef=p.ent_coef,
            device=self._device(device),
        )


@dataclasses.dataclass
class NPGParams:
    hidden_sizes: tuple[int, ...] = (64, 64)
    critic_lr: float = 1e-3
    gamma: float = 0.99
    gae_lambda: float = 0.95
    optim_critic_iters: int = 5
    trust_region_size: float = 0.5
    adv_norm: bool = True
    ret_norm: bool = True


class NPGExperimentBuilder(ExperimentBuilder):
    trainer_kind = "onpolicy"

    def _make_algo(self, envs: Environments, device: str | None = None) -> Algorithm:
        from tianshou_tpu_torch.algos.npg import NPG

        p = getattr(self, "params", NPGParams())
        actor, critic = _make_actor_critic(envs, p.hidden_sizes)
        return NPG(
            actor, critic, envs.action_space,
            critic_lr=p.critic_lr, gamma=p.gamma, gae_lambda=p.gae_lambda,
            optim_critic_iters=p.optim_critic_iters,
            trust_region_size=p.trust_region_size,
            adv_norm=p.adv_norm, ret_norm=p.ret_norm,
            device=self._device(device),
        )


@dataclasses.dataclass
class TRPOParams(NPGParams):
    max_kl: float = 0.01
    backtrack_coeff: float = 0.8
    max_backtracks: int = 10


class TRPOExperimentBuilder(ExperimentBuilder):
    trainer_kind = "onpolicy"

    def _make_algo(self, envs: Environments, device: str | None = None) -> Algorithm:
        from tianshou_tpu_torch.algos.npg import TRPO

        p = getattr(self, "params", TRPOParams())
        actor, critic = _make_actor_critic(envs, p.hidden_sizes)
        return TRPO(
            actor, critic, envs.action_space,
            critic_lr=p.critic_lr, gamma=p.gamma, gae_lambda=p.gae_lambda,
            optim_critic_iters=p.optim_critic_iters,
            adv_norm=p.adv_norm, ret_norm=p.ret_norm,
            max_kl=p.max_kl, backtrack_coeff=p.backtrack_coeff,
            max_backtracks=p.max_backtracks,
            device=self._device(device),
        )


@dataclasses.dataclass
class SACParams:
    hidden_sizes: tuple[int, ...] = (256, 256)
    actor_lr: float = 1e-3
    critic_lr: float = 1e-3
    alpha_lr: float = 3e-4
    auto_alpha: bool = True
    alpha: float = 0.2
    gamma: float = 0.99
    tau: float = 0.005
    n_step: int = 1


class SACExperimentBuilder(ExperimentBuilder):
    trainer_kind = "offpolicy"

    def with_sac_params(self, params: SACParams):
        return self.with_params(params)

    def _make_algo(self, envs: Environments, device: str | None = None) -> Algorithm:
        from tianshou_tpu_torch.algos.sac import SAC
        from tianshou_tpu_torch.networks.continuous import CriticEnsemble, GaussianActor

        p = getattr(self, "params", SACParams())
        assert isinstance(envs.action_space, Box)
        return SAC(
            actor=GaussianActor(_shape(envs), p.hidden_sizes, _act_dim(envs), conditioned_sigma=True),
            critic=CriticEnsemble(_shape(envs), _act_dim(envs), p.hidden_sizes, num_critics=2),
            action_space=envs.action_space,
            actor_lr=p.actor_lr, critic_lr=p.critic_lr, alpha_lr=p.alpha_lr,
            alpha=p.alpha, auto_alpha=p.auto_alpha,
            gamma=p.gamma, tau=p.tau, n_step=p.n_step,
            device=self._device(device),
        )


@dataclasses.dataclass
class DiscreteSACParams:
    hidden_sizes: tuple[int, ...] = (128, 128)
    actor_lr: float = 1e-3
    critic_lr: float = 1e-3
    alpha: float = 0.05
    auto_alpha: bool = True
    alpha_lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005
    n_step: int = 1


class DiscreteSACExperimentBuilder(ExperimentBuilder):
    trainer_kind = "offpolicy"

    def _make_algo(self, envs: Environments, device: str | None = None) -> Algorithm:
        from tianshou_tpu_torch.algos.sac import DiscreteSAC
        from tianshou_tpu_torch.networks.common import QNet, QNetEnsemble

        p = getattr(self, "params", DiscreteSACParams())
        assert isinstance(envs.action_space, Discrete)
        n = envs.action_space.n
        return DiscreteSAC(
            actor=QNet(_shape(envs), p.hidden_sizes, n),
            critic=QNetEnsemble(_shape(envs), p.hidden_sizes, n, num_critics=2),
            action_space=envs.action_space,
            actor_lr=p.actor_lr, critic_lr=p.critic_lr,
            alpha=p.alpha, auto_alpha=p.auto_alpha, alpha_lr=p.alpha_lr,
            gamma=p.gamma, tau=p.tau, n_step=p.n_step,
            device=self._device(device),
        )


@dataclasses.dataclass
class TD3Params:
    hidden_sizes: tuple[int, ...] = (256, 256)
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005
    exploration_noise: float = 0.1
    policy_noise: float = 0.2
    noise_clip: float = 0.5
    update_actor_freq: int = 2


class TD3ExperimentBuilder(ExperimentBuilder):
    trainer_kind = "offpolicy"

    def with_td3_params(self, params: TD3Params):
        return self.with_params(params)

    def _make_algo(self, envs: Environments, device: str | None = None) -> Algorithm:
        from tianshou_tpu_torch.algos.ddpg import TD3
        from tianshou_tpu_torch.networks.continuous import CriticEnsemble, DeterministicActor

        p = getattr(self, "params", TD3Params())
        return TD3(
            actor=DeterministicActor(_shape(envs), p.hidden_sizes, _act_dim(envs)),
            critic=CriticEnsemble(_shape(envs), _act_dim(envs), p.hidden_sizes, num_critics=2),
            action_space=envs.action_space,
            actor_lr=p.actor_lr, critic_lr=p.critic_lr,
            gamma=p.gamma, tau=p.tau,
            exploration_noise=p.exploration_noise,
            policy_noise=p.policy_noise, noise_clip=p.noise_clip,
            update_actor_freq=p.update_actor_freq,
            device=self._device(device),
        )


@dataclasses.dataclass
class DDPGParams:
    hidden_sizes: tuple[int, ...] = (256, 256)
    actor_lr: float = 1e-3
    critic_lr: float = 1e-3
    gamma: float = 0.99
    tau: float = 0.005
    exploration_noise: float = 0.1
    n_step: int = 1


class DDPGExperimentBuilder(ExperimentBuilder):
    trainer_kind = "offpolicy"

    def _make_algo(self, envs: Environments, device: str | None = None) -> Algorithm:
        from tianshou_tpu_torch.algos.ddpg import DDPG
        from tianshou_tpu_torch.networks.continuous import CriticEnsemble, DeterministicActor

        p = getattr(self, "params", DDPGParams())
        return DDPG(
            actor=DeterministicActor(_shape(envs), p.hidden_sizes, _act_dim(envs)),
            critic=CriticEnsemble(_shape(envs), _act_dim(envs), p.hidden_sizes, num_critics=1),
            action_space=envs.action_space,
            actor_lr=p.actor_lr, critic_lr=p.critic_lr,
            gamma=p.gamma, tau=p.tau, n_step=p.n_step,
            exploration_noise=p.exploration_noise,
            device=self._device(device),
        )


@dataclasses.dataclass
class BCParams:
    hidden_sizes: tuple[int, ...] = (128, 128)
    lr: float = 1e-3


class BCExperimentBuilder(ExperimentBuilder):
    """Behavior cloning from a dataset (offline)."""

    trainer_kind = "offline"

    def _make_algo(self, envs: Environments, device: str | None = None) -> Algorithm:
        from tianshou_tpu_torch.algos.offline import BC
        from tianshou_tpu_torch.networks.common import QNet
        from tianshou_tpu_torch.networks.continuous import DeterministicActor

        p = getattr(self, "params", BCParams())
        if isinstance(envs.action_space, Discrete):
            actor = QNet(_shape(envs), p.hidden_sizes, envs.action_space.n)
        else:
            actor = DeterministicActor(_shape(envs), p.hidden_sizes, _act_dim(envs))
        return BC(actor, envs.action_space, lr=p.lr, device=self._device(device))


@dataclasses.dataclass
class CQLParams:
    """CQL, CQL(Lagrange) and CalQL settings."""

    hidden_sizes: tuple[int, ...] = (256, 256)
    actor_lr: float = 1e-4
    critic_lr: float = 3e-4
    alpha: float = 0.2
    auto_alpha: bool = True
    alpha_lr: float = 1e-4
    gamma: float = 0.99
    tau: float = 0.005
    cql_weight: float = 1.0
    temperature: float = 1.0
    num_repeat_actions: int = 10
    with_lagrange: bool = True
    lagrange_threshold: float = 10.0
    cql_alpha_lr: float = 1e-4
    calibrated: bool = False


class CQLExperimentBuilder(ExperimentBuilder):
    trainer_kind = "offline"

    def _make_algo(self, envs: Environments, device: str | None = None) -> Algorithm:
        from tianshou_tpu_torch.algos.offline import CQL
        from tianshou_tpu_torch.networks.continuous import CriticEnsemble, GaussianActor

        p = getattr(self, "params", CQLParams())
        return CQL(
            actor=GaussianActor(_shape(envs), p.hidden_sizes, _act_dim(envs), conditioned_sigma=True),
            critic=CriticEnsemble(_shape(envs), _act_dim(envs), p.hidden_sizes, num_critics=2),
            action_space=envs.action_space,
            actor_lr=p.actor_lr, critic_lr=p.critic_lr,
            alpha=p.alpha, auto_alpha=p.auto_alpha, alpha_lr=p.alpha_lr,
            gamma=p.gamma, tau=p.tau,
            cql_weight=p.cql_weight, temperature=p.temperature,
            num_repeat_actions=p.num_repeat_actions,
            with_lagrange=p.with_lagrange,
            lagrange_threshold=p.lagrange_threshold,
            cql_alpha_lr=p.cql_alpha_lr, calibrated=p.calibrated,
            device=self._device(device),
        )


@dataclasses.dataclass
class TD3BCParams(TD3Params):
    bc_alpha: float = 2.5


class TD3BCExperimentBuilder(ExperimentBuilder):
    trainer_kind = "offline"

    def _make_algo(self, envs: Environments, device: str | None = None) -> Algorithm:
        from tianshou_tpu_torch.algos.offline import TD3BC
        from tianshou_tpu_torch.networks.continuous import CriticEnsemble, DeterministicActor

        p = getattr(self, "params", TD3BCParams())
        return TD3BC(
            actor=DeterministicActor(_shape(envs), p.hidden_sizes, _act_dim(envs)),
            critic=CriticEnsemble(_shape(envs), _act_dim(envs), p.hidden_sizes, num_critics=2),
            action_space=envs.action_space,
            actor_lr=p.actor_lr, critic_lr=p.critic_lr,
            gamma=p.gamma, tau=p.tau,
            policy_noise=p.policy_noise, noise_clip=p.noise_clip,
            update_actor_freq=p.update_actor_freq,
            bc_alpha=p.bc_alpha,
            device=self._device(device),
        )


@dataclasses.dataclass
class REDQParams:
    hidden_sizes: tuple[int, ...] = (256, 256)
    ensemble_size: int = 10
    subset_size: int = 2


class REDQExperimentBuilder(ExperimentBuilder):
    trainer_kind = "offpolicy"

    def _make_algo(self, envs: Environments, device: str | None = None) -> Algorithm:
        from tianshou_tpu_torch.algos.redq import REDQ
        from tianshou_tpu_torch.networks.continuous import CriticEnsemble, GaussianActor

        p = getattr(self, "params", REDQParams())
        return REDQ(
            actor=GaussianActor(_shape(envs), p.hidden_sizes, _act_dim(envs), conditioned_sigma=True),
            critic=CriticEnsemble(_shape(envs), _act_dim(envs), p.hidden_sizes, num_critics=p.ensemble_size),
            action_space=envs.action_space,
            ensemble_size=p.ensemble_size,
            subset_size=p.subset_size,
            device=self._device(device),
        )
