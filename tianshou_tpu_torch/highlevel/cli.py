"""Declarative command line over the experiment builders (port of
``tianshou_tpu/highlevel/cli.py``).

Every field of :class:`ExperimentConfig`, :class:`SamplingConfig` and the
chosen algorithm's params dataclass becomes a ``--section.field`` flag with
the dataclass default; ``--experiment.device`` picks the device (``cuda``
by default, which raises without CUDA).

Usage::

    python -m tianshou_tpu_torch.highlevel.cli --algo dqn --task CartPole-v1 \\
        --sampling.num_epochs 5 --params.lr 5e-4 --experiment.seed 3
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any

__all__ = ["build_parser", "dataclass_from_args", "experiment_cli", "ALGO_REGISTRY", "OFFLINE_ALGOS"]


def _add_dataclass_args(parser: argparse.ArgumentParser, dc_type: type, prefix: str) -> None:
    """One ``--prefix.field`` flag per scalar or int-tuple field."""
    for f in dataclasses.fields(dc_type):
        if not f.init:
            continue
        if f.default is not dataclasses.MISSING:
            default = f.default
        elif f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
            default = f.default_factory()  # type: ignore[misc]
        else:
            default = None
        name = f"--{prefix}.{f.name}"
        if isinstance(default, bool):
            parser.add_argument(name, type=lambda s: s.lower() in ("1", "true", "yes"), default=default,
                                metavar="BOOL")
        elif isinstance(default, (int, float, str)):
            parser.add_argument(name, type=type(default), default=default)
        elif isinstance(default, tuple) and all(isinstance(x, int) for x in default):
            parser.add_argument(name, type=int, nargs="*", default=list(default))
        # non-scalar fields (callables, nested objects) are API-only


def dataclass_from_args(dc_type: type, ns: argparse.Namespace, prefix: str):
    """``dc_type`` from the parsed ``--prefix.*`` flags."""
    kwargs: dict[str, Any] = {}
    for f in dataclasses.fields(dc_type):
        key = f"{prefix}.{f.name}"
        if hasattr(ns, key):
            val = getattr(ns, key)
            kwargs[f.name] = tuple(val) if isinstance(val, list) else val
    return dc_type(**kwargs)


#: offline algorithms need ``--dataset`` (an HDF5 replay buffer or a D4RL
#: dataset)
OFFLINE_ALGOS = frozenset({"bc", "cql", "td3_bc"})


def _registry():
    from tianshou_tpu_torch.highlevel import experiment as ex

    return {
        "dqn": (ex.DQNExperimentBuilder, ex.DQNParams, "with_params"),
        "iqn": (ex.IQNExperimentBuilder, ex.IQNParams, "with_params"),
        "ppo": (ex.PPOExperimentBuilder, ex.PPOParams, "with_params"),
        "a2c": (ex.A2CExperimentBuilder, ex.OnPolicyParams, "with_params"),
        "pg": (ex.PGExperimentBuilder, ex.PGParams, "with_params"),
        "npg": (ex.NPGExperimentBuilder, ex.NPGParams, "with_params"),
        "trpo": (ex.TRPOExperimentBuilder, ex.TRPOParams, "with_params"),
        "sac": (ex.SACExperimentBuilder, ex.SACParams, "with_params"),
        "discrete_sac": (ex.DiscreteSACExperimentBuilder, ex.DiscreteSACParams, "with_params"),
        "td3": (ex.TD3ExperimentBuilder, ex.TD3Params, "with_params"),
        "ddpg": (ex.DDPGExperimentBuilder, ex.DDPGParams, "with_params"),
        "redq": (ex.REDQExperimentBuilder, ex.REDQParams, "with_params"),
        "bc": (ex.BCExperimentBuilder, ex.BCParams, "with_params"),
        "cql": (ex.CQLExperimentBuilder, ex.CQLParams, "with_params"),
        "td3_bc": (ex.TD3BCExperimentBuilder, ex.TD3BCParams, "with_params"),
    }


class _Lazy(dict):
    def __missing__(self, key):
        self.update(_registry())
        return self[key]


ALGO_REGISTRY: dict = _Lazy()


def build_parser(algo: str | None = None) -> argparse.ArgumentParser:
    from tianshou_tpu_torch.highlevel.config import SamplingConfig
    from tianshou_tpu_torch.highlevel.experiment import ExperimentConfig

    parser = argparse.ArgumentParser(description="tianshou_tpu_torch high-level experiment CLI")
    parser.add_argument("--algo", required=algo is None, default=algo, choices=sorted(_registry()))
    parser.add_argument("--task", default="CartPole-v1", help="the port's env name or a gymnasium id")
    parser.add_argument("--gym", action="store_true", help="force the gymnasium host-env factory")
    parser.add_argument("--watch", action="store_true", help="evaluate greedily after training (watch loop)")
    parser.add_argument("--dataset", default=None,
                        help="replay dataset (required for offline algos: " + ", ".join(sorted(OFFLINE_ALGOS)) + ")")
    _add_dataclass_args(parser, ExperimentConfig, "experiment")
    _add_dataclass_args(parser, SamplingConfig, "sampling")
    if algo is not None:
        _, params_t, _ = _registry()[algo]
        if params_t is not None:
            _add_dataclass_args(parser, params_t, "params")
    return parser


def experiment_cli(argv: list[str] | None = None):
    """Parse the flags, build and run the experiment; returns its result.
    Raises before building anything when the device is unavailable."""
    from tianshou_tpu_torch.highlevel.config import SamplingConfig
    from tianshou_tpu_torch.highlevel.env import GymEnvFactory, TorchEnvFactory
    from tianshou_tpu_torch.highlevel.experiment import ExperimentConfig
    from tianshou_tpu_torch.utils.device import resolve_device

    pre, _ = build_parser("dqn").parse_known_args(argv)
    algo = pre.algo
    ns = build_parser(algo).parse_args(argv)

    builder_t, params_t, setter = _registry()[algo]
    config = dataclass_from_args(ExperimentConfig, ns, "experiment")
    resolve_device(config.device)
    sampling = dataclass_from_args(SamplingConfig, ns, "sampling")
    try:
        factory = TorchEnvFactory(ns.task) if not ns.gym else GymEnvFactory(ns.task)
    except KeyError:
        factory = GymEnvFactory(ns.task)
    builder = builder_t(factory, config=config, sampling=sampling)
    if params_t is not None and setter is not None:
        getattr(builder, setter)(dataclass_from_args(params_t, ns, "params"))
    if algo in OFFLINE_ALGOS:
        if ns.dataset is None:
            raise SystemExit(f"--dataset is required for offline algo {algo!r}")
        builder.with_offline_data(ns.dataset)
    if ns.watch:
        builder.config.watch = True
    return builder.build().run()


if __name__ == "__main__":
    res = experiment_cli()
    info = res.info
    print(
        f"best_reward={info.best_reward:.1f}±{info.best_reward_std:.1f} "
        f"env_steps={info.env_step} epochs={info.epoch} stop={info.stop_triggered}"
    )
