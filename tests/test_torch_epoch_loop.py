"""The epoch protocol of the port's training loops, on the CPU at tiny
sizes: the off-policy device, host-segment and fused host runs, the
on-policy device and host runs, the offline run and both distributed
trainers without a process group.

Each case records, in order, every call a run makes to its logger, to
``train_param_fn``, ``stop_fn``, ``save_best_fn`` and
``save_checkpoint_fn``, with its arguments (a dict's keys in place of its
values), the returns those calls carry, the metrics each train or update
log carries, and the run's ``InfoStats`` counters and ``last_metrics``.
``stop_fn`` answers from a script by the index of its call: the cases
cover a resumed run, early stops after a test phase, and in-training tests
both refused and confirmed.

Episodes end at their fifth step (CartPole's pole cannot fall sooner), so
that every segment ends episodes and every return is 5.0: what a run calls,
and with which returns, does not depend on the random streams, which differ
between the two packages.  For the six paths the JAX package has, the
port's recording must equal the JAX trainer's from the same configuration,
recorded the same way: the calls, the returns, the counters, the names in
``last_metrics`` and which train log's metrics ``last_metrics`` equals (at
rtol 1e-5; none where the run smoothed metrics it did not log), which says
when each trainer takes a step's metrics.  The distributed trainers, which
the JAX package does not have, must equal ``tests/data/epoch_loop.json``,
the metrics included at rtol 1e-5; ``EPOCH_LOOP_RECORD=<path>`` writes
this run's recordings of every case there instead of comparing them.
"""

from __future__ import annotations

import json
import os
import pathlib
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

gym = pytest.importorskip("gymnasium")

from tianshou_tpu.algos.dqn import DQN as JaxDQN  # noqa: E402
from tianshou_tpu.algos.offline import BC as JaxBC  # noqa: E402
from tianshou_tpu.algos.ppo import PPO as JaxPPO  # noqa: E402
from tianshou_tpu.collect.collector import Collector as JaxCollector  # noqa: E402
from tianshou_tpu.collect.host_collector import HostCollector as JaxHostCollector  # noqa: E402
from tianshou_tpu.data.buffer import ReplayBuffer as JaxReplayBuffer  # noqa: E402
from tianshou_tpu.envs import host as jhost  # noqa: E402
from tianshou_tpu.envs.base import VectorEnv as JaxVectorEnv  # noqa: E402
from tianshou_tpu.envs.classic import CartPole as JaxCartPole  # noqa: E402
from tianshou_tpu.networks.common import QNet as JaxQNet  # noqa: E402
from tianshou_tpu.networks.continuous import ValueNet as JaxValueNet  # noqa: E402
from tianshou_tpu.trainer.offline import OfflineTrainer as JaxOfflineTrainer  # noqa: E402
from tianshou_tpu.trainer.offpolicy import OffPolicyTrainer as JaxOffPolicyTrainer  # noqa: E402
from tianshou_tpu.trainer.onpolicy import OnPolicyTrainer as JaxOnPolicyTrainer  # noqa: E402
from tianshou_tpu_torch.algos.dqn import DQN  # noqa: E402
from tianshou_tpu_torch.algos.offline import BC  # noqa: E402
from tianshou_tpu_torch.algos.ppo import PPO  # noqa: E402
from tianshou_tpu_torch.collect.collector import Collector  # noqa: E402
from tianshou_tpu_torch.collect.host_collector import HostCollector  # noqa: E402
from tianshou_tpu_torch.data.buffer import ReplayBuffer  # noqa: E402
from tianshou_tpu_torch.envs.base import VectorEnv  # noqa: E402
from tianshou_tpu_torch.envs.classic import CartPole  # noqa: E402
from tianshou_tpu_torch.envs.host import HostVectorEnv  # noqa: E402
from tianshou_tpu_torch.networks.common import QNet  # noqa: E402
from tianshou_tpu_torch.networks.continuous import ValueNet  # noqa: E402
from tianshou_tpu_torch.trainer.distributed import DistributedOffPolicyTrainer, DistributedOnPolicyTrainer  # noqa: E402
from tianshou_tpu_torch.trainer.offline import OfflineTrainer  # noqa: E402
from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer  # noqa: E402
from tianshou_tpu_torch.trainer.onpolicy import OnPolicyTrainer  # noqa: E402

GOLDEN = pathlib.Path(__file__).parent / "data" / "epoch_loop.json"
CPU = "cpu"
EPISODE = 5  # steps an episode: every segment below ends some


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs in several worker processes
    yield
    torch.set_num_threads(threads)


class ShortCartPole(CartPole):
    MAX_STEPS = EPISODE


class JaxShortCartPole(JaxCartPole):
    MAX_STEPS = EPISODE


def _gym_cartpole():
    return gym.make("CartPole-v1", max_episode_steps=EPISODE)


class Recorder:
    """The run's calls, in order: a logger's and the wrapped hooks'."""

    def __init__(self, stops=(), restore=None):
        self.calls: list[list] = []
        self.returns: list[float] = []  # the returns the calls carried, in order
        self.logged: list[dict] = []  # the metrics of each train or update log
        self.stops, self.n_stop = list(stops), 0
        self.restore = restore

    def _data(self, name: str, data: dict, step: int) -> None:
        self.calls.append([name, step, sorted(data)])
        self.returns += [float(data[k]) for k in ("returns_mean", "returns_std") if k in data]
        if name != "log_test":
            self.logged.append({k: float(v) for k, v in data.items() if k not in ("env_step", "returns_mean")})

    # -- the logger --------------------------------------------------------------
    def log_train_data(self, data, step):
        self._data("log_train", data, step)

    def log_update_data(self, data, step):
        self._data("log_update", data, step)

    def log_test_data(self, data, step):
        self._data("log_test", data, step)

    def save_data(self, epoch, env_step, gradient_step, save_checkpoint_fn=None):
        self.calls.append(["save_data", epoch, env_step, gradient_step])
        if save_checkpoint_fn is not None:
            save_checkpoint_fn(epoch, env_step, gradient_step)

    def restore_data(self):
        self.calls.append(["restore_data"])
        return self.restore

    # -- the hooks ---------------------------------------------------------------
    def train_param_fn(self, epoch, env_step):
        self.calls.append(["train_param_fn", epoch, env_step])
        return 0.5

    def stop_fn(self, reward):
        answer = self.n_stop < len(self.stops) and self.stops[self.n_stop]
        self.n_stop += 1
        self.calls.append(["stop_fn", answer])
        self.returns.append(float(reward))
        return answer

    def save_best_fn(self, ts):
        self.calls.append(["save_best_fn"])

    def save_checkpoint_fn(self, epoch, env_step, gradient_step):
        self.calls.append(["save_checkpoint_fn", epoch, env_step, gradient_step])


def _port_offline_data(algo, col, buffer):
    ts = algo.init(torch.Generator().manual_seed(1))
    cstate = col.reset(torch.Generator().manual_seed(2))
    bstate = buffer.init(col.example_transition(ts, cstate), device=CPU)
    return col.collect(ts, cstate, bstate, 16, explore=True, random=True)[1]


def _jax_offline_data(algo, col, buffer):
    cstate = col.reset(jax.random.key(2))
    ts = algo.init(jax.random.key(1), cstate.obs[0])
    bstate = buffer.init(col.example_transition(ts, cstate))
    return col.collect(ts, cstate, bstate, 16, explore=True, explore_param=1.0)[1]  # epsilon 1: random


# the two packages' parts under one set of names: what differs is the
# port's device and its networks' input sizes
PORT = SimpleNamespace(
    venv=lambda n: VectorEnv(ShortCartPole(), n, device=CPU),
    host_venv=lambda n: HostVectorEnv([_gym_cartpole] * n),
    collector=lambda algo, venv, buffer=None: Collector(algo, venv, buffer, device=CPU),
    host_collector=lambda algo, venv, buffer=None: HostCollector(algo, venv, buffer, device=CPU),
    buffer=ReplayBuffer,
    dqn=lambda: DQN(QNet(4, (16,), 2), CartPole.action_space, target_update_freq=20, device=CPU),
    ppo=lambda: PPO(QNet(4, (16,), 2), ValueNet(4, (16,)), CartPole.action_space, device=CPU),
    bc=lambda: BC(QNet(4, (16,), 2), CartPole.action_space, device=CPU),
    offline_data=_port_offline_data,
    OffPolicyTrainer=OffPolicyTrainer, OnPolicyTrainer=OnPolicyTrainer, OfflineTrainer=OfflineTrainer,
    kw={"device": CPU},
)
JAX = SimpleNamespace(
    venv=lambda n: JaxVectorEnv(JaxShortCartPole(), n),
    host_venv=lambda n: jhost.HostVectorEnv([_gym_cartpole] * n),
    collector=JaxCollector,
    host_collector=JaxHostCollector,
    buffer=JaxReplayBuffer,
    dqn=lambda: JaxDQN(JaxQNet((16,), 2), JaxCartPole.action_space, target_update_freq=20),
    ppo=lambda: JaxPPO(JaxQNet((16,), 2), JaxValueNet((16,)), JaxCartPole.action_space),
    bc=lambda: JaxBC(JaxQNet((16,), 2), JaxCartPole.action_space),
    offline_data=_jax_offline_data,
    OffPolicyTrainer=JaxOffPolicyTrainer, OnPolicyTrainer=JaxOnPolicyTrainer, OfflineTrainer=JaxOfflineTrainer,
    kw={},
)


def _hooks(rec: Recorder, *names: str) -> dict:
    return {name: getattr(rec, name) for name in names}


OFF_HOOKS = ("train_param_fn", "stop_fn", "save_best_fn", "save_checkpoint_fn")
OFF_KW = dict(step_per_epoch=128, step_per_collect=64, update_per_step=1 / 32, batch_size=16, episode_per_test=2,
              warmup_steps=32, seed=0)


def _offpolicy_device(p, rec):
    algo, buffer = p.dqn(), p.buffer(256, 4)
    return p.OffPolicyTrainer(
        algo, p.collector(algo, p.venv(4), buffer), p.collector(algo, p.venv(2)), buffer, max_epoch=3,
        logger=rec, resume_from_log=True, test_in_train=True, smooth_window=3, **_hooks(rec, *OFF_HOOKS),
        **OFF_KW, **p.kw)


def _offpolicy_host(p, rec, num_envs=4, **kw):
    algo, buffer = p.dqn(), p.buffer(256, num_envs)
    train = p.host_collector(algo, p.host_venv(num_envs), buffer)
    return p.OffPolicyTrainer(
        algo, train, p.host_collector(algo, p.host_venv(2)), buffer, logger=rec, **_hooks(rec, *OFF_HOOKS),
        **{**OFF_KW, "max_epoch": 3, "smooth_window": 2, "test_in_train": True, **kw}, **p.kw)


def _offpolicy_fused(p, rec):
    return _offpolicy_host(p, rec, num_envs=2, step_per_epoch=32, step_per_collect=2, update_per_step=0.5,
                           fused_fine_host=True, max_epoch=2)


ON_KW = dict(max_epoch=3, step_per_epoch=128, step_per_collect=64, repeat_per_collect=1, batch_size=32,
             episode_per_test=2, seed=0)
ON_HOOKS = ("stop_fn", "save_best_fn", "save_checkpoint_fn")


def _onpolicy_device(p, rec):
    algo = p.ppo()
    return p.OnPolicyTrainer(algo, p.collector(algo, p.venv(4)), p.collector(algo, p.venv(2)), logger=rec,
                             test_in_train=True, smooth_window=2, **_hooks(rec, *ON_HOOKS), **ON_KW, **p.kw)


def _onpolicy_host(p, rec):
    algo = p.ppo()
    return p.OnPolicyTrainer(algo, p.host_collector(algo, p.host_venv(4)), p.host_collector(algo, p.host_venv(2)),
                             logger=rec, **_hooks(rec, *ON_HOOKS), **ON_KW, **p.kw)


def _offline(p, rec):
    dqn, buffer = p.dqn(), p.buffer(64, 4)
    bstate = p.offline_data(dqn, p.collector(dqn, p.venv(4), buffer), buffer)
    bc = p.bc()
    return p.OfflineTrainer(bc, buffer, bstate, p.collector(bc, p.venv(2)), max_epoch=3, update_per_epoch=5,
                            batch_size=8, episode_per_test=2, updates_per_superstep=2, logger=rec, seed=0,
                            **_hooks(rec, "stop_fn", "save_best_fn"), **p.kw)


def _dist_offpolicy(p, rec):
    algo, buffer = p.dqn(), p.buffer(256, 4)
    return DistributedOffPolicyTrainer(
        algo, p.collector(algo, p.venv(4), buffer), p.collector(algo, p.venv(2)), buffer, max_epoch=3,
        logger=rec, **_hooks(rec, "train_param_fn", "stop_fn"), **OFF_KW, **p.kw)


def _dist_onpolicy(p, rec):
    algo = p.ppo()
    return DistributedOnPolicyTrainer(
        algo, p.collector(algo, p.venv(4)), p.collector(algo, p.venv(2)), logger=rec, **_hooks(rec, "stop_fn"),
        **{**ON_KW, "max_epoch": 2}, **p.kw)


# case: (its trainer, stop_fn's answers by call, what restore_data returns)
CASES = {
    "offpolicy_device": (_offpolicy_device, (True, False, False, False, True, True), (1, 96, 6)),
    "offpolicy_host": (_offpolicy_host, (True, False, False, True, True), None),
    "offpolicy_fused": (_offpolicy_fused, (False, True, False, False, True, True), None),
    "onpolicy_device": (_onpolicy_device, (True, False, False, False, True, True), None),
    "onpolicy_host": (_onpolicy_host, (), None),
    "offline": (_offline, (False, True), None),
    "dist_offpolicy": (_dist_offpolicy, (False, True), None),
    "dist_onpolicy": (_dist_onpolicy, (), None),
}
PORT_ONLY = ("dist_offpolicy", "dist_onpolicy")
# where the port departs from the JAX package: its host runs read the last
# segment's metrics once more when the run ends, where the JAX package's
# keep their last periodic read (every 4096 env steps: none in these runs)
FINAL_READ = {"offpolicy_host": ["loss", "td_abs_mean"], "offpolicy_fused": ["loss", "td_abs_mean"]}

INFO_COUNTERS = ("gradient_step", "env_step", "epoch", "stop_triggered")


def _source(logged: list[dict], last: dict) -> int | None:
    """How many logs back the metrics equal ``last`` (None: none)."""
    for back, metrics in enumerate(reversed(logged)):
        if metrics.keys() == last.keys() and all(np.isclose(metrics[k], last[k], rtol=1e-5, atol=0) for k in last):
            return back
    return None


def _record(case: str, package: SimpleNamespace) -> dict:
    build, stops, restore = CASES[case]
    rec = Recorder(stops, restore)
    trainer = build(package, rec)
    try:
        info = trainer.run()
    finally:
        for col in (getattr(trainer, "train_collector", None), trainer.test_collector):
            close = getattr(getattr(col, "venv", None), "close", None)
            if close is not None:
                close()
    assert info.best_reward == EPISODE
    last = {k: float(v) for k, v in info.last_metrics.items()}
    return {"calls": rec.calls, "returns": rec.returns, "info": {k: getattr(info, k) for k in INFO_COUNTERS},
            "last_metrics": sorted(last), "source": _source(rec.logged, last),
            "floats": {"logged": rec.logged, "last_metrics": last}}


RECORD = os.environ.get("EPOCH_LOOP_RECORD")


@pytest.fixture(scope="module")
def recorded():
    runs: dict = {}
    yield runs
    if RECORD:
        pathlib.Path(RECORD).write_text(json.dumps(runs, indent=1, sort_keys=True))


def _assert_floats_close(got, want, what: str) -> None:
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _assert_floats_close(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_floats_close(g, w, f"{what}[{i}]")
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0, err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_epoch_protocol_is_pinned(case, recorded):
    recorded[case] = got = _record(case, PORT)
    if RECORD:
        return
    if case in PORT_ONLY:
        want = json.loads(GOLDEN.read_text())[case]
        _assert_floats_close(got.pop("floats"), want.pop("floats"), "floats")
    else:
        want = _record(case, JAX)
        got.pop("floats"), want.pop("floats")
        if case in FINAL_READ:
            want.update(last_metrics=FINAL_READ[case], source=None)
    assert got.pop("returns") == pytest.approx(want.pop("returns"), rel=1e-5)
    assert got == want
