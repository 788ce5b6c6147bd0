"""The port's copy of the CQL case of tests/test_offline_e2e.py:159-168, at
the same settings and seeds, on the CPU: CQL (Lagrange, 10 repeated
actions, GaussianActor and twin critics (128, 128)) reaches a test reward
of -600 through ``OfflineTrainer`` (at most 6 epochs of 1000 updates of
batch 256) from the HDF5 round trip of the port's own SAC data
(tests/test_torch_offline_e2e.py's fixture, shared by import).  It runs
about 100 s on the CPU (two epochs of 1000 updates, each on 7,680
sampled-action rows), so it carries the ``slow`` marker."""

import pytest

from tests.test_torch_offline_e2e import _run_offline, one_thread, pendulum_data  # noqa: F401
from tianshou_tpu_torch.algos.offline import CQL
from tianshou_tpu_torch.envs.classic import Pendulum
from tianshou_tpu_torch.networks.continuous import CriticEnsemble, GaussianActor


@pytest.mark.slow
def test_cql_pendulum(pendulum_data):
    env = Pendulum()
    algo = CQL(GaussianActor(3, (128, 128), 1, conditioned_sigma=True), CriticEnsemble(3, 1, (128, 128), 2),
               env.action_space, cql_weight=1.0, num_repeat_actions=10, device="cpu")
    _run_offline(algo, *pendulum_data, env, -600, update_per_epoch=1000)
