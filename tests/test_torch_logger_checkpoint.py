"""The port's loggers, checkpoints and trainer hooks (tianshou_tpu_torch:
utils/logger, utils/checkpoint, trainer/hooks and the hooks of the three
trainers) against the JAX package, on the CPU.

- The tensorboard logger's round trip and the interval gating (copies of
  ``tests/test_utils_misc.py:76-100``), and the wandb logger against a fake
  ``wandb`` (a copy of ``tests/test_wandb_logger.py``).
- The logger call sequence: a recording ``BaseLogger`` on the JAX trainer
  and on the port's, from the same configuration, records the same list of
  (scope, step, key set) writes and the same ``save_data`` triples, for the
  off-policy trainer's device and host loops, the on-policy trainer and the
  offline trainer.
- Checkpoints: a ``TrainState``, a ``ReplayBufferState`` and a
  ``PrioritizedReplayBufferState`` (its sum tree and the ``tree[1]`` total
  included) round-trip bitwise and share no storage with the state they
  came from or the template; the file loads with ``weights_only=True``; a
  template of another shape, dtype or structure raises;
  ``latest_checkpoint_step`` agrees with the JAX function on the same
  directory names.
- A run checkpointed through ``save_checkpoint_fn`` and resumed through the
  tensorboard logger (a port of ``tests/test_utils_misc.py:285-335``), and a
  ``profile_dir`` trace.
"""

import dataclasses
import json
import os
import sys
import types

import jax
import pytest
import torch

from tianshou_tpu.utils.logger import BaseLogger as JaxBaseLogger
from tianshou_tpu_torch.algos.dqn import DQN
from tianshou_tpu_torch.collect.collector import Collector
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer import ReplayBuffer
from tianshou_tpu_torch.data.prio import PrioritizedReplayBuffer
from tianshou_tpu_torch.data.tree import tree_leaves
from tianshou_tpu_torch.envs.base import VectorEnv
from tianshou_tpu_torch.envs.classic import CartPole
from tianshou_tpu_torch.networks.common import QNet
from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer
from tianshou_tpu_torch.utils.checkpoint import latest_checkpoint_step, restore_checkpoint, save_checkpoint
from tianshou_tpu_torch.utils.logger import BaseLogger, LazyLogger, TensorboardLogger

CPU = "cpu"


# -- loggers ----------------------------------------------------------------
def test_tensorboard_logger_roundtrip(tmp_path):
    pytest.importorskip("tensorboard")
    logger = TensorboardLogger(str(tmp_path), train_interval=1)
    logger.log_train_data({"returns_mean": 1.5, "nested": {"x": 2.0}}, 10)
    logger.save_data(3, 1000, 50)
    logger.finalize()
    logger2 = TensorboardLogger(str(tmp_path))
    epoch, env_step, grad_step = logger2.restore_data()
    assert (epoch, env_step, grad_step) == (3, 1000, 50)
    data = logger2.restore_logged_data()
    assert "train/returns_mean" in data
    assert data["train/returns_mean"][0] == (10, 1.5)
    assert "train/nested/x" in data


def test_lazy_logger_and_intervals():
    logger = LazyLogger()
    logger.log_train_data({"x": 1}, 0)  # no-op, must not raise
    writes = []

    class Rec(BaseLogger):
        def write(self, step, data):
            writes.append(step)

    r = Rec(train_interval=100)
    r.log_train_data({"x": 1}, 0)  # 0 - (-1) < 100: skipped
    r.log_train_data({"x": 1}, 120)  # 121 >= 100: written
    r.log_train_data({"x": 1}, 150)  # 30 < 100: skipped
    r.log_train_data({"x": 1}, 240)
    assert writes == [120, 240]


class _FakeArtifact:
    def __init__(self, name, type):
        self.name = name
        self.type = type
        self.files = []
        self.dirs = []

    def add_file(self, p):
        self.files.append(p)

    def add_dir(self, p):
        self.dirs.append(p)

    def download(self, root):
        self.downloaded_to = root
        return root


class _FakeRun:
    def __init__(self, **kw):
        self.kw = kw
        self.id = kw.get("id") or "fake123"
        self.summary = {}
        self.logged = []
        self.artifacts = []
        self.finished = False

    def log(self, data, step=None):
        self.logged.append((step, dict(data)))

    def log_artifact(self, art):
        self.artifacts.append(art)

    def use_artifact(self, name):
        art = _FakeArtifact(name, "model")
        self.artifacts.append(art)
        return art

    def finish(self):
        self.finished = True


def _install_fake_wandb(monkeypatch):
    mod = types.ModuleType("wandb")
    mod.runs = []

    def init(**kw):
        run = _FakeRun(**kw)
        mod.runs.append(run)
        return run

    mod.init = init
    mod.Artifact = _FakeArtifact
    monkeypatch.setitem(sys.modules, "wandb", mod)
    return mod


def test_wandb_logger_logs_and_resumes(monkeypatch, tmp_path):
    mod = _install_fake_wandb(monkeypatch)
    from tianshou_tpu_torch.utils.logger import WandbLogger

    lg = WandbLogger(project="p", name="n", resume_id="abc", log_dir=str(tmp_path))
    assert lg.run_id == "abc"
    assert mod.runs[0].kw["resume"] == "allow"
    lg.log_test_data({"returns_mean": 1.5}, 100)
    assert mod.runs[0].logged[0][0] == 100

    ckpt = os.path.join(tmp_path, "ckpt.bin")
    with open(ckpt, "wb") as f:
        f.write(b"x" * 10)
    lg.save_data(3, 30000, 3000, save_checkpoint_fn=lambda e, s, g: ckpt)
    run = mod.runs[0]
    assert run.summary["save/env_step"] == 30000
    assert run.artifacts and run.artifacts[0].files == [ckpt]
    assert run.artifacts[0].name == "run_abc_checkpoint"

    epoch, env_step, grad_step = lg.restore_data()
    assert (epoch, env_step, grad_step) == (3, 30000, 3000)
    lg.finalize()
    assert run.finished


def test_wandb_missing_raises_unless_optional(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)  # forces ImportError
    from tianshou_tpu_torch.utils.logger import WandbLogger

    with pytest.raises(ImportError):
        WandbLogger()
    lg = WandbLogger(optional=True)
    assert lg.wandb_run is None
    assert "wandb not installed" in capsys.readouterr().err
    lg.log_train_data({"x": 1.0}, 1)  # no-op, no crash
    assert lg.restore_data() == (0, 0, 0)
    lg.finalize()


# -- the logger call sequence against the JAX trainers --------------------------
def _recording(base):
    class Recording(base):
        def __init__(self):
            super().__init__(train_interval=1, test_interval=1, update_interval=1, info_interval=1)
            self.writes: list[tuple[str, int, frozenset]] = []
            self.saves: list[tuple[int, int, int]] = []

        def write(self, step, data):
            scopes = {k.split("/", 1)[0] for k in data}
            assert len(scopes) == 1, data
            self.writes.append((scopes.pop(), step, frozenset(data)))

        def save_data(self, epoch, env_step, gradient_step, save_checkpoint_fn=None):
            self.saves.append((epoch, env_step, gradient_step))
            super().save_data(epoch, env_step, gradient_step, save_checkpoint_fn)

    return Recording()


# 4 envs x 40 steps a segment under a uniformly random policy: every
# segment ends CartPole episodes in both packages, so the train scope's
# key set (returns_mean only when episodes end) is the same in both
OFF_KW = dict(max_epoch=2, step_per_epoch=320, step_per_collect=160, update_per_step=0.1, batch_size=32,
              episode_per_test=2, warmup_steps=50, seed=0, train_param_fn=lambda e, s: 1.0)
ON_KW = dict(max_epoch=2, step_per_epoch=320, step_per_collect=160, repeat_per_collect=1, batch_size=64,
             episode_per_test=2, seed=0)


def _jax_offpolicy(logger, host):
    from tianshou_tpu.algos.dqn import DQN as JDQN
    from tianshou_tpu.collect.collector import Collector as JCollector
    from tianshou_tpu.collect.host_collector import HostCollector as JHostCollector
    from tianshou_tpu.data.buffer import ReplayBuffer as JBuffer
    from tianshou_tpu.envs.base import VectorEnv as JVectorEnv
    from tianshou_tpu.envs.classic import CartPole as JCartPole
    from tianshou_tpu.envs.host import HostVectorEnv as JHostVectorEnv
    from tianshou_tpu.envs.spaces import Discrete as JDiscrete
    from tianshou_tpu.networks.common import QNet as JQNet
    from tianshou_tpu.trainer.offpolicy import OffPolicyTrainer as JTrainer

    algo = JDQN(JQNet((32,), 2), JDiscrete(2), target_update_freq=50)
    buffer = JBuffer(capacity=200, num_envs=4)
    if host:
        import gymnasium as gym

        make = lambda: gym.make("CartPole-v1")  # noqa: E731
        train, test = JHostCollector(algo, JHostVectorEnv([make] * 4), buffer), JHostCollector(
            algo, JHostVectorEnv([make] * 2))
    else:
        train, test = JCollector(algo, JVectorEnv(JCartPole(), 4), buffer), JCollector(algo, JVectorEnv(JCartPole(), 2))
    return JTrainer(algo, train, test, buffer, logger=logger, **OFF_KW)


def _port_offpolicy(logger, host, **kw):
    from tianshou_tpu_torch.collect.host_collector import HostCollector
    from tianshou_tpu_torch.envs.host import HostVectorEnv

    env = CartPole()
    algo = DQN(QNet(4, (32,), 2), env.action_space, target_update_freq=50, device=CPU)
    buffer = ReplayBuffer(capacity=200, num_envs=4)
    if host:
        import gymnasium as gym

        make = lambda: gym.make("CartPole-v1")  # noqa: E731
        train, test = (HostCollector(algo, HostVectorEnv([make] * 4), buffer, device=CPU),
                       HostCollector(algo, HostVectorEnv([make] * 2), device=CPU))
    else:
        train = Collector(algo, VectorEnv(env, 4, device=CPU), buffer, device=CPU)
        test = Collector(algo, VectorEnv(env, 2, device=CPU), device=CPU)
    return OffPolicyTrainer(algo, train, test, buffer, logger=logger, device=CPU, **{**OFF_KW, **kw})


def _jax_onpolicy(logger):
    from tianshou_tpu.algos.ppo import PPO as JPPO
    from tianshou_tpu.collect.collector import Collector as JCollector
    from tianshou_tpu.envs.base import VectorEnv as JVectorEnv
    from tianshou_tpu.envs.classic import CartPole as JCartPole
    from tianshou_tpu.envs.spaces import Discrete as JDiscrete
    from tianshou_tpu.networks.common import QNet as JQNet
    from tianshou_tpu.networks.continuous import ValueNet as JValueNet
    from tianshou_tpu.trainer.onpolicy import OnPolicyTrainer as JTrainer

    algo = JPPO(JQNet((32,), 2), JValueNet((32,)), JDiscrete(2))
    return JTrainer(algo, JCollector(algo, JVectorEnv(JCartPole(), 4)), JCollector(algo, JVectorEnv(JCartPole(), 2)),
                    logger=logger, **ON_KW)


def _port_onpolicy(logger):
    from tianshou_tpu_torch.algos.ppo import PPO
    from tianshou_tpu_torch.networks.continuous import ValueNet
    from tianshou_tpu_torch.trainer.onpolicy import OnPolicyTrainer

    env = CartPole()
    algo = PPO(QNet(4, (32,), 2), ValueNet(4, (32,)), env.action_space, device=CPU)
    return OnPolicyTrainer(algo, Collector(algo, VectorEnv(env, 4, device=CPU), device=CPU),
                           Collector(algo, VectorEnv(env, 2, device=CPU), device=CPU), logger=logger, device=CPU,
                           **ON_KW)


@pytest.fixture(scope="module")
def pendulum_dataset(tmp_path_factory):
    """A random Pendulum rollout of the JAX package, as its HDF5 file."""
    from tianshou_tpu.algos.base import RandomPolicy as JRandom
    from tianshou_tpu.collect.collector import Collector as JCollector
    from tianshou_tpu.data.buffer import ReplayBuffer as JBuffer
    from tianshou_tpu.data.persistence import save_buffer_hdf5
    from tianshou_tpu.envs.base import VectorEnv as JVectorEnv
    from tianshou_tpu.envs.classic import Pendulum as JPendulum

    env = JPendulum()
    algo = JRandom(env.action_space)
    buffer = JBuffer(capacity=100, num_envs=4)
    col = JCollector(algo, JVectorEnv(env, 4), buffer)
    cstate = col.reset(jax.random.key(0))
    ts = algo.init(jax.random.key(1), None)
    bstate = buffer.init(col.example_transition(ts, cstate))
    _, bstate, _, _ = col.collect(ts, cstate, bstate, 25)
    path = str(tmp_path_factory.mktemp("offline") / "pendulum.h5")
    save_buffer_hdf5(path, bstate)
    return path


OFFLINE_KW = dict(max_epoch=2, update_per_epoch=20, batch_size=32, episode_per_test=2, updates_per_superstep=10,
                  seed=0)


def _jax_offline(logger, path):
    from tianshou_tpu.algos.offline import BC as JBC
    from tianshou_tpu.collect.collector import Collector as JCollector
    from tianshou_tpu.data.persistence import load_any_buffer
    from tianshou_tpu.envs.base import VectorEnv as JVectorEnv
    from tianshou_tpu.envs.classic import Pendulum as JPendulum
    from tianshou_tpu.networks.continuous import DeterministicActor as JActor
    from tianshou_tpu.trainer.offline import OfflineTrainer as JTrainer

    env = JPendulum()
    algo = JBC(JActor((16,), 1), env.action_space)
    buffer, bstate = load_any_buffer(path)
    return JTrainer(algo, buffer, bstate, JCollector(algo, JVectorEnv(env, 2)), logger=logger, **OFFLINE_KW)


def _port_offline(logger, path):
    from tianshou_tpu_torch.algos.offline import BC
    from tianshou_tpu_torch.data.persistence import load_any_buffer
    from tianshou_tpu_torch.envs.classic import Pendulum
    from tianshou_tpu_torch.networks.continuous import DeterministicActor
    from tianshou_tpu_torch.trainer.offline import OfflineTrainer

    env = Pendulum()
    algo = BC(DeterministicActor(3, (16,), 1), env.action_space, device=CPU)
    buffer, bstate = load_any_buffer(path, device=CPU)
    return OfflineTrainer(algo, buffer, bstate, Collector(algo, VectorEnv(env, 2, device=CPU), device=CPU),
                          logger=logger, device=CPU, **OFFLINE_KW)


@pytest.mark.parametrize("kind", ["offpolicy_device", "offpolicy_host", "onpolicy", "offline"])
def test_logger_call_sequence_matches_jax(kind, request):
    if kind == "offpolicy_host":
        pytest.importorskip("gymnasium")
    jlog, tlog = _recording(JaxBaseLogger), _recording(BaseLogger)
    if kind.startswith("offpolicy"):
        host = kind.endswith("host")
        _jax_offpolicy(jlog, host).run()
        _port_offpolicy(tlog, host).run()
    elif kind == "onpolicy":
        _jax_onpolicy(jlog).run()
        _port_onpolicy(tlog).run()
    else:
        path = request.getfixturevalue("pendulum_dataset")
        _jax_offline(jlog, path).run()
        _port_offline(tlog, path).run()
    assert tlog.writes, "the port's trainer wrote nothing"
    assert tlog.writes == jlog.writes
    assert tlog.saves == jlog.saves
    if kind != "offline":
        assert [e for e, _, _ in tlog.saves] == [1, 2]  # one save a finished epoch


# -- checkpoints ------------------------------------------------------------------
def _state_tensors(state) -> list[torch.Tensor]:
    """Every tensor of a train or buffer state, module parameters and
    optimizer state included, in a fixed order."""
    out = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.nn.Module):
            out += list(v.state_dict().values())
        elif isinstance(v, torch.optim.Optimizer):
            out += [t for s in v.state_dict()["state"].values() for t in s.values() if isinstance(t, torch.Tensor)]
        elif isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, dict):
            out += tree_leaves(v)
    return out


def _assert_bitwise_and_own(restored, source, template):
    got, ref, tmpl = _state_tensors(restored), _state_tensors(source), _state_tensors(template)
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape and torch.equal(g, r)
    own = {t.untyped_storage().data_ptr() for t in got if t.numel()}
    others = {t.untyped_storage().data_ptr() for t in ref + tmpl if t.numel()}
    assert not own & others, "the restored state shares storage with the source or the template"


def _trained_dqn(seed=0, epochs=1):
    tr = _port_offpolicy(None, False, max_epoch=epochs, seed=seed)
    tr.run()
    return tr


def test_train_and_buffer_state_round_trip(tmp_path):
    tr = _trained_dqn()
    fresh = _trained_dqn(seed=1, epochs=1)  # the template: another run's states of the same shapes
    for name, state, template in (("train", tr.train_state, fresh.train_state),
                                  ("buffer", tr.buffer_state, fresh.buffer_state)):
        path = save_checkpoint(str(tmp_path / name), state, step=7)
        assert path.endswith("step_7")
        restored = restore_checkpoint(path, template)
        _assert_bitwise_and_own(restored, state, template)
    ts = restore_checkpoint(str(tmp_path / "train" / "step_7"), fresh.train_state)
    assert ts.step == tr.train_state.step
    # the optimizer steps the restored network's own parameters
    assert ts.optimizer.param_groups[0]["params"][0] is next(ts.online.parameters())
    # the file holds tensors and plain containers only
    saved = torch.load(os.path.join(path, "checkpoint.pt"), weights_only=True)
    assert saved["leaves"] and all(isinstance(t, torch.Tensor) for t in saved["leaves"])


def test_prioritized_state_round_trip_with_total(tmp_path):
    from tianshou_tpu_torch.ops.segtree import segtree_total

    buf = PrioritizedReplayBuffer(capacity=16, num_envs=3, alpha=0.6, beta=0.4)
    example = {"obs": torch.zeros(4), "act": torch.zeros((), dtype=torch.int64), "rew": torch.zeros(()),
               "terminated": torch.zeros((), dtype=torch.bool), "truncated": torch.zeros((), dtype=torch.bool),
               "obs_next": torch.zeros(4)}
    state = buf.init(Batch(example), device=CPU)
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        step = Batch({k: torch.rand((3,) + v.shape, generator=g).to(v.dtype) for k, v in example.items()})
        state = buf.add(state, step)
    env_idx, pos = torch.tensor([0, 1, 2, 1]), torch.tensor([3, 5, 7, 5])
    state = buf.update_priorities(state, env_idx, pos, torch.tensor([0.5, 2.0, 1.5, 3.0]))
    template = buf.init(Batch(example), device=CPU)
    path = save_checkpoint(str(tmp_path / "per"), state)
    restored = restore_checkpoint(path, template)
    _assert_bitwise_and_own(restored, state, template)
    assert torch.equal(segtree_total(restored.tree), segtree_total(state.tree))
    # the restored tree is a tensor of its own: a write-back moves its total
    # and leaves the source's alone
    before = segtree_total(state.tree).clone()
    restored = buf.update_priorities(restored, torch.tensor([0]), torch.tensor([0]), torch.tensor([50.0]))
    assert torch.equal(segtree_total(state.tree), before)
    assert not torch.equal(segtree_total(restored.tree), before)
    # a view saved on its own (the total) restores as its own value
    holder = {"total": segtree_total(state.tree), "tree": state.tree}
    back = restore_checkpoint(save_checkpoint(str(tmp_path / "view"), holder),
                              {"total": torch.zeros(()), "tree": torch.zeros_like(state.tree)})
    assert torch.equal(back["total"], before) and torch.equal(back["tree"], state.tree)


def test_mismatched_template_raises(tmp_path):
    tr = _trained_dqn()
    path = save_checkpoint(str(tmp_path / "s"), tr.buffer_state)
    wider = ReplayBuffer(capacity=201, num_envs=4)
    with pytest.raises(ValueError):
        restore_checkpoint(path, wider.init(tr.train_collector.example_transition(tr.train_state, tr.collect_state),
                                            device=CPU))
    as_float = dataclasses.replace(tr.buffer_state, cursor=tr.buffer_state.cursor.double())
    with pytest.raises(ValueError):
        restore_checkpoint(path, as_float)
    with pytest.raises(ValueError):
        restore_checkpoint(path, tr.train_state)
    path = save_checkpoint(str(tmp_path / "t"), tr.train_state)
    other = DQN(QNet(4, (16,), 2), CartPole().action_space, device=CPU).init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):
        restore_checkpoint(path, other)


def test_latest_checkpoint_step_matches_jax(tmp_path):
    from tianshou_tpu.utils.checkpoint import latest_checkpoint_step as jax_latest

    assert latest_checkpoint_step(str(tmp_path / "none")) is None
    for name in ("step_3", "step_12", "step_x", "other", "step_7"):
        (tmp_path / name).mkdir()
    assert latest_checkpoint_step(str(tmp_path)) == jax_latest(str(tmp_path)) == 12


def test_trainer_checkpoint_and_resume(tmp_path):
    """Per-epoch checkpoints through ``save_checkpoint_fn`` and a resumed
    run whose counters come back from the tensorboard log."""
    pytest.importorskip("tensorboard")
    saved = []
    ckpt_dir = str(tmp_path / "state")

    def make_trainer(resume):
        env = CartPole()
        algo = DQN(QNet(4, (32,), 2), env.action_space, target_update_freq=50, device=CPU)
        buffer = ReplayBuffer(capacity=200, num_envs=4)
        trainer = OffPolicyTrainer(
            algo,
            Collector(algo, VectorEnv(env, 4, device=CPU), buffer, device=CPU),
            Collector(algo, VectorEnv(env, 4, device=CPU), device=CPU),
            buffer,
            max_epoch=2, step_per_epoch=200, step_per_collect=40, update_per_step=0.1, batch_size=32,
            episode_per_test=2, warmup_steps=50, seed=0,
            logger=TensorboardLogger(str(tmp_path)),
            save_checkpoint_fn=lambda e, s, g: saved.append((e, s, g)),
            resume_from_log=resume,
            device=CPU,
        )
        return trainer

    trainer = make_trainer(resume=False)
    info = trainer.run()
    assert len(saved) == 2  # one checkpoint an epoch
    assert saved[-1][0] == 2

    path = save_checkpoint(ckpt_dir, trainer.train_state, step=saved[-1][0])
    assert latest_checkpoint_step(ckpt_dir) == 2
    restored = restore_checkpoint(path, trainer.train_state)
    assert restored.step == trainer.train_state.step

    # resume: counters restored from the event log, epochs continued
    trainer2 = make_trainer(resume=True)
    trainer2.max_epoch = 3
    info2 = trainer2.run()
    assert info2.epoch == 3
    assert info2.env_step > info.env_step  # continued past the restored count
    assert saved[-1][0] == 3


def test_profile_dir_writes_a_trace(tmp_path):
    tr = _port_offpolicy(None, False, max_epoch=1, step_per_epoch=160, profile_dir=str(tmp_path / "trace"))
    tr.run()
    assert tr.trace_path is not None and os.path.dirname(tr.trace_path) == str(tmp_path / "trace")
    with open(tr.trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("addmm" in n or "linear" in n for n in names), sorted(names)[:20]


def test_hooks_off_by_default_add_nothing():
    tr = _port_offpolicy(None, False, max_epoch=1, step_per_epoch=160)
    assert tr.logger is None and tr.save_checkpoint_fn is None and tr.profile_dir is None
    info = tr.run()
    assert tr.trace_path is None and info.epoch == 1
