"""The declarative high-level API (port of ``examples/highlevel_dqn.py``,
the reference's ``ExperimentBuilder`` usage): DQN on CartPole in a few
lines.  The JAX script has no flags; this one has ``--device``.

    python -m tianshou_tpu_torch.examples.highlevel_dqn [--device cpu]
"""

from __future__ import annotations

import argparse


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    return p


def build(args, logger=None):
    """``(the experiment builder, venvs to close)``: the experiment builds
    its own envs, on the device.  ``logger`` is for ``run`` (``main`` passes
    it), not the builder."""
    from tianshou_tpu_torch.highlevel.config import SamplingConfig
    from tianshou_tpu_torch.highlevel.env import TorchEnvFactory
    from tianshou_tpu_torch.highlevel.experiment import DQNExperimentBuilder, DQNParams, ExperimentConfig

    builder = (
        DQNExperimentBuilder(
            TorchEnvFactory("CartPole-v1"),
            config=ExperimentConfig(logger="tensorboard", device=args.device),
            sampling=SamplingConfig(
                num_epochs=10,
                step_per_epoch=10000,
                step_per_collect=100,
                update_per_step=0.1,
                batch_size=64,
                buffer_size=20000,
                start_timesteps=1000,
            ),
        )
        .with_dqn_params(DQNParams(hidden_sizes=(128, 128, 128), gamma=0.9))
        .with_seed(0)
        .with_stop_fn(lambda rew: rew >= 195)
    )
    return builder, []


def main(argv=None, logger=None):
    """``logger`` replaces the ``TensorboardLogger`` the config names, and
    then nothing is written under ``log/`` (no log directory, so no saved
    experiment beside it)."""
    args = parser().parse_args(argv)
    builder, _ = build(args, logger)
    if logger is None:
        result = builder.build().run()
    else:
        result = builder.with_logger("none").build().run(logger=logger)
    print(f"best={result.info.best_reward:.1f} env_steps={result.info.env_step} log_dir={result.log_dir}")
    return result.info


if __name__ == "__main__":
    main()
