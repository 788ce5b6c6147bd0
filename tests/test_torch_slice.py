"""The pixel DQN slice of the port as a whole (tianshou_tpu_torch) against
the JAX package, on the CPU at a small size: SyntheticPixelEnv(36, 36, 2),
NatureCNN in float32 (so that argmax ties and bf16 rounding cannot differ),
3 envs, ring capacity 16.

(a) From the same parameters and env phases, one greedy segment gives
    identical actions and bitwise-identical buffer storage; then the
    presample of the same indices and k updates give the same losses and
    parameters (rtol 1e-4 / atol 1e-5).
(b) OffPolicyTrainer.run() completes with the right counters.
(c) Without CUDA, every entry point's default device raises.
(d) The port imports nothing of JAX or of tianshou_tpu, the modules of
    each slice checked by name (slice 5: segtree, PER and the
    distributional family; slice 6: the noise processes, REDQ,
    DiscreteSAC, BDQ, DRQN and the recurrent hooks; slice 11: the process
    groups, meshes and distributed trainers), and without CUDA the
    distributed entry points raise too.
(f) Completeness: every public top-level name of every module of the JAX
    package (read with ``ast``, not imported) has a counterpart in the
    port's module of the same path, but for an explicit list of exceptions,
    each with its reason.
(e) The same comparison as (a) on the paths of slice 2: a greedy CartPole
    segment (QNet, float32; storage within atol 1e-6), a MinAtar Breakout
    segment (sticky actions off) and a deduplicated stacked pixel segment
    (SyntheticPixelEnv(36, 36, 2, channel_first=True), stack_num=2,
    save_only_last_obs, ignore_obs_next), both with bitwise-equal storage;
    then the presample of the same indices and k updates.  Resets are fixed
    on both sides, so an auto-reset inside the segment is injected too.
"""

import ast
import math
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.algos.dqn import DQN as JaxDQN
from tianshou_tpu.collect.collector import Collector as JaxCollector
from tianshou_tpu.collect.collector import rollout_segment as jax_rollout_segment
from tianshou_tpu.data.buffer import ReplayBuffer as JaxReplayBuffer
from tianshou_tpu.envs.base import VectorEnv as JaxVectorEnv
from tianshou_tpu.envs.synthetic import SyntheticPixelEnv as JaxPixelEnv
from tianshou_tpu.envs.synthetic import SyntheticPixelState as JaxPixelState
from tianshou_tpu.networks.conv import ConvQNet as JaxConvQNet
from tianshou_tpu.trainer.offpolicy import build_update_scan as jax_build_update_scan
from tianshou_tpu_torch.algos.dqn import DQN
from tianshou_tpu_torch.collect.collector import Collector, rollout_segment
from tianshou_tpu_torch.data.buffer import ReplayBuffer
from tianshou_tpu_torch.envs.base import VectorEnv
from tianshou_tpu_torch.envs.synthetic import SyntheticPixelEnv, SyntheticPixelState
from tianshou_tpu_torch.networks.conv import ConvQNet
from tianshou_tpu_torch.networks.convert import params_from_flax
from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer, build_update_scan

REPO = pathlib.Path(__file__).resolve().parents[1]
H, W, C, A = 36, 36, 2, 4
N_ENVS, CAP, SEG = 3, 16, 20  # the segment wraps the ring
K, BATCH, N_STEP = 3, 8, 3


def _jax_side(env_seeds, lr=1e-3):
    env = JaxPixelEnv(H, W, C, num_actions=A, episode_len=64)
    venv = JaxVectorEnv(env, N_ENVS)
    buf = JaxReplayBuffer(CAP, N_ENVS)
    algo = JaxDQN(
        JaxConvQNet(num_actions=A, encoder="nature", encoder_kwargs={"compute_dtype": jnp.float32}),
        env.action_space, lr=lr, gamma=0.99, n_step=N_STEP, target_update_freq=2,
    )
    col = JaxCollector(algo, venv, buf)
    cstate = col.reset(jax.random.key(0))
    es = JaxPixelState(jnp.zeros(N_ENVS, jnp.int32), jnp.asarray(env_seeds))
    cstate = cstate.replace(env_state=es, obs=jax.vmap(env._frame)(es.t, es.seed))
    ts = algo.init(jax.random.key(1), cstate.obs[0])
    bstate = buf.init(col.example_transition(ts, cstate))
    return algo, venv, buf, ts, cstate, bstate


def _torch_side(env_seeds, flax_params, lr=1e-3):
    env = SyntheticPixelEnv(H, W, C, num_actions=A, episode_len=64)
    venv = VectorEnv(env, N_ENVS, device="cpu")
    buf = ReplayBuffer(CAP, N_ENVS)
    algo = DQN(
        ConvQNet((H, W, C), A, encoder_kwargs={"compute_dtype": torch.float32}),
        env.action_space, lr=lr, gamma=0.99, n_step=N_STEP, target_update_freq=2, device="cpu",
    )
    col = Collector(algo, venv, buf, device="cpu")
    cstate = col.reset(torch.Generator().manual_seed(0))
    es = SyntheticPixelState(torch.zeros(N_ENVS, dtype=torch.int32), torch.from_numpy(env_seeds))
    cstate.env_state, cstate.obs = es, env.frame(es.t, es.seed)
    ts = algo.init(torch.Generator().manual_seed(1))
    sd = params_from_flax(flax_params)
    ts.online.load_state_dict(sd)
    ts.target.load_state_dict(sd)
    bstate = buf.init(col.example_transition(ts, cstate), device="cpu")
    return algo, venv, buf, ts, cstate, bstate


def test_slice_matches_jax():
    rng = np.random.default_rng(0)
    env_seeds = rng.integers(0, 1 << 20, N_ENVS).astype(np.int32)
    jalgo, jvenv, jbuf, jts, jcs, jbs = _jax_side(env_seeds)
    talgo, tvenv, tbuf, tts, tcs, tbs = _torch_side(env_seeds, jax.device_get(jts.params))

    # one greedy segment
    jseg = jax.jit(jax_rollout_segment(jalgo, jvenv, jbuf, SEG, explore=False, record_traj=False))
    jcs, jbs, jout = jseg(jts, jcs, jbs, 0.0)
    tcs, tbs, tout = rollout_segment(talgo, tvenv, tbuf, SEG, explore=False)(tts, tcs, tbs, 0.0)
    np.testing.assert_array_equal(tbs.storage["act"].numpy(), np.asarray(jbs.storage["act"]))
    assert len(np.unique(np.asarray(jbs.storage["act"]))) > 1
    for k in jbs.storage:
        np.testing.assert_array_equal(tbs.storage[k].numpy(), np.asarray(jbs.storage[k]), err_msg=k)
    np.testing.assert_array_equal(tbs.cursor.numpy(), np.asarray(jbs.cursor))
    np.testing.assert_array_equal(tbs.size.numpy(), np.asarray(jbs.size))
    np.testing.assert_array_equal(tcs.obs.numpy(), np.asarray(jcs.obs))
    for k in ("done", "ep_ret", "ep_len"):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]))

    # the same K * BATCH indices through each side's presample and K updates
    env_idx = rng.integers(0, N_ENVS, K * BATCH)
    pos = rng.integers(0, CAP, K * BATCH)
    ones = np.ones(K * BATCH, np.float32)
    jbuf.sample_with_weights = lambda st, key, b: (
        jnp.asarray(env_idx, jnp.int32), jnp.asarray(pos, jnp.int32), jnp.asarray(ones))
    tbuf.sample_with_weights = lambda st, g, b: (
        torch.from_numpy(env_idx), torch.from_numpy(pos), torch.from_numpy(ones))
    jts, _, jm = jax_build_update_scan(jalgo, jbuf, BATCH, K)(jts, jbs, jax.random.key(2))
    tts, _, tm = build_update_scan(talgo, tbuf, BATCH, K)(tts, tbs, torch.Generator())
    assert tts.step == int(jts.step) == K
    for k in ("loss", "td_abs_mean"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-5)
    for mod, flax_params in ((tts.online, jts.params), (tts.target, jts.target_params)):
        ref = params_from_flax(jax.device_get(flax_params))
        for name, val in mod.state_dict().items():
            np.testing.assert_allclose(val.numpy(), ref[name].numpy(), rtol=1e-4, atol=1e-5, err_msg=name)


def _tiny_trainer(device="cpu", **kw):
    env = SyntheticPixelEnv(H, W, C, num_actions=A, episode_len=5)
    buf = ReplayBuffer(CAP, N_ENVS)
    algo = DQN(ConvQNet((H, W, C), A), env.action_space, n_step=N_STEP, target_update_freq=4, device=device)
    train = Collector(algo, VectorEnv(env, N_ENVS, device=device), buf, device=device)
    test = Collector(algo, VectorEnv(env, 2, device=device), device=device)
    return OffPolicyTrainer(
        algo, train, test, buf, max_epoch=2, step_per_epoch=20, step_per_collect=6,
        update_per_step=0.5, batch_size=BATCH, episode_per_test=3, device=device,
        train_param_fn=lambda epoch, step: 0.1, **kw,
    )


@pytest.mark.parametrize("warmup_steps", [0, 6])
def test_trainer_run_completes(warmup_steps):
    trainer = _tiny_trainer(warmup_steps=warmup_steps)
    assert (trainer.segment_len, trainer.steps_per_segment, trainer.updates_per_segment) == (2, 6, 3)
    info = trainer.run()
    # 20 steps an epoch take ceil(20 / 6) = 4 supersteps of 6 env steps
    assert info.epoch == 2
    assert info.env_step == warmup_steps + 2 * 4 * 6
    assert info.gradient_step == 2 * 4 * 3 == trainer.train_state.step
    assert math.isfinite(info.last_metrics["loss"]) and math.isfinite(info.best_reward)
    # the synthetic env pays 1 when (t + action) % 7 == 0: at most 1 per 5-step episode
    assert 0.0 <= info.best_reward <= 1.0
    assert int(trainer.buffer_state.size.min()) == min(CAP, info.env_step // N_ENVS)


@pytest.mark.parametrize("test_in_train", [False, True])
def test_trainer_stops_on_stop_fn(test_in_train):
    saved = []
    trainer = _tiny_trainer(stop_fn=lambda reward: True, test_in_train=test_in_train,
                            save_best_fn=lambda ts: saved.append(ts.step))
    info = trainer.run()
    assert info.stop_triggered and info.epoch == 1
    if test_in_train:
        # the first episodes end (t = 5) in the third superstep of 2 steps
        assert info.env_step == 3 * 6 and saved == []
    else:
        assert info.env_step == 4 * 6 and saved == [4 * 3]


def _entry_points():
    from tianshou_tpu_torch.algos.bdq import BDQ
    from tianshou_tpu_torch.algos.multiagent import MultiAgentPolicyManager
    from tianshou_tpu_torch.collect.async_collector import AsyncHostCollector, AsyncHostVectorEnv
    from tianshou_tpu_torch.collect.host_collector import HostCollector
    from tianshou_tpu_torch.envs.atari import FakeAtariEnv, make_atari_env
    from tianshou_tpu_torch.envs.tictactoe import TicTacToe
    from tianshou_tpu_torch.algos.c51 import C51
    from tianshou_tpu_torch.algos.drqn import DRQN
    from tianshou_tpu_torch.algos.gail import GAIL
    from tianshou_tpu_torch.algos.icm import ICM, ICMNet
    from tianshou_tpu_torch.algos.offline import BC, BCQ, CQL, TD3BC, DiscreteBCQ, DiscreteCQL, DiscreteCRR
    from tianshou_tpu_torch.algos.psrl import PSRL
    from tianshou_tpu_torch.algos.qrdqn import QRDQN
    from tianshou_tpu_torch.algos.redq import REDQ
    from tianshou_tpu_torch.algos.sac import DiscreteSAC
    from tianshou_tpu_torch.data.her import HERReplayBuffer
    from tianshou_tpu_torch.highlevel.cli import experiment_cli
    from tianshou_tpu_torch.highlevel.env import TorchEnvFactory
    from tianshou_tpu_torch.highlevel.experiment import DQNExperimentBuilder
    from tianshou_tpu_torch.data.persistence import buffer_from_d4rl
    from tianshou_tpu_torch.data.prio import PrioritizedReplayBuffer
    from tianshou_tpu_torch.envs.spaces import Box, Discrete, MultiDiscrete
    from tianshou_tpu_torch.exploration.noise import OUNoise
    from tianshou_tpu_torch.networks.common import BranchingQNet, QNetEnsemble, RecurrentQNet
    from tianshou_tpu_torch.networks.continuous import (
        VAE, Critic, CriticEnsemble, DeterministicActor, GaussianActor, Perturbation, ValueNet)
    from tianshou_tpu_torch.networks.conv import ConvQRDQNNet
    from tianshou_tpu_torch.networks.discrete import C51Net, QRDQNNet
    from tianshou_tpu_torch.trainer.offline import OfflineTrainer
    from tianshou_tpu_torch.parallel.distributed import global_mesh, init_distributed
    from tianshou_tpu_torch.data.batch import Batch
    from tianshou_tpu_torch.envs.minatar import Seaquest
    from tianshou_tpu_torch.parallel.mesh import make_mesh, make_mesh2
    from tianshou_tpu_torch.trainer.distributed import DistributedOffPolicyTrainer, DistributedOnPolicyTrainer

    env = SyntheticPixelEnv(H, W, C, num_actions=A)
    algo = DQN(ConvQNet((H, W, C), A), env.action_space, device="cpu")
    venv = VectorEnv(env, N_ENVS, device="cpu")
    col = Collector(algo, venv, device="cpu")
    example = col.example_transition(algo.init(torch.Generator().manual_seed(0)),
                                     col.reset(torch.Generator().manual_seed(0)))
    box = Box(-1.0, 1.0, (1,))
    d4rl = {k: np.zeros((4, 3), np.float32) for k in ("observations", "next_observations")}
    d4rl.update(actions=np.zeros((4, 1), np.float32), rewards=np.zeros(4), terminals=np.zeros(4, bool))
    return {
        "VectorEnv": lambda: VectorEnv(env, N_ENVS),
        "ReplayBuffer.init": lambda: ReplayBuffer(CAP, N_ENVS).init(example),
        "DQN": lambda: DQN(ConvQNet((H, W, C), A), env.action_space),
        "Collector": lambda: Collector(algo, venv),
        "OffPolicyTrainer": lambda: OffPolicyTrainer(
            algo, col, col, ReplayBuffer(CAP, N_ENVS), max_epoch=1, step_per_epoch=1, step_per_collect=1),
        "PrioritizedReplayBuffer.init": lambda: PrioritizedReplayBuffer(CAP, N_ENVS).init(example),
        "C51": lambda: C51(C51Net((H, W, C), (8,), A, num_atoms=5, noisy=True), env.action_space),
        "QRDQN": lambda: QRDQN(ConvQRDQNNet((H, W, C), A, 8, "nature"), env.action_space),
        "REDQ": lambda: REDQ(GaussianActor(3, (8,), 1), CriticEnsemble(3, 1, (8,), 4), Box(-1.0, 1.0, (1,)),
                             ensemble_size=4),
        "DiscreteSAC": lambda: DiscreteSAC(QNet(4, (8,), 2), QNetEnsemble(4, (8,), 2), Discrete(2)),
        "BDQ": lambda: BDQ(BranchingQNet(4, (8,), 2, 3), MultiDiscrete((3, 3))),
        "DRQN": lambda: DRQN(RecurrentQNet(4, 8, 2), Discrete(2)),
        "OUNoise": lambda: OUNoise(),
        "BC": lambda: BC(DeterministicActor(3, (8,), 1), box),
        "TD3BC": lambda: TD3BC(DeterministicActor(3, (8,), 1), CriticEnsemble(3, 1, (8,)), box),
        "BCQ": lambda: BCQ(Perturbation(3, (8,), 1), CriticEnsemble(3, 1, (8,)), VAE(3, (8,), 1, 2), box),
        "CQL": lambda: CQL(GaussianActor(3, (8,), 1, conditioned_sigma=True), CriticEnsemble(3, 1, (8,)), box),
        "DiscreteBCQ": lambda: DiscreteBCQ(QNet(4, (8,), 2), QNet(4, (8,), 2), Discrete(2)),
        "DiscreteCQL": lambda: DiscreteCQL(QRDQNNet(4, (8,), 2, 8), Discrete(2), num_quantiles=8),
        "DiscreteCRR": lambda: DiscreteCRR(QNet(4, (8,), 2), QNet(4, (8,), 2), Discrete(2)),
        "buffer_from_d4rl": lambda: buffer_from_d4rl(d4rl),
        "OfflineTrainer": lambda: OfflineTrainer(
            algo, ReplayBuffer(CAP, N_ENVS), ReplayBuffer(CAP, N_ENVS).init(example, device="cpu"), col,
            max_epoch=1, update_per_epoch=1),
        "HERReplayBuffer.init": lambda: HERReplayBuffer(
            CAP, N_ENVS, compute_reward_fn=None, achieved_slice=(0, 1), desired_slice=(1, 2)).init(example),
        "ICM": lambda: ICM(DQN(QNet(4, (8,), 2), Discrete(2)), ICMNet(4, (8,), 4, 2)),
        "GAIL": lambda: GAIL(GaussianActor(3, (8,), 1), ValueNet(3, (8,)), box, disc_net=Critic(3, 1, (8,)),
                             expert_buffer=ReplayBuffer(CAP, 1), expert_buffer_state=None),
        "PSRL": lambda: PSRL(5, Discrete(2)),
        "ExperimentConfig().run": lambda: DQNExperimentBuilder(TorchEnvFactory("CartPole-v1")).build().run(),
        "experiment_cli": lambda: experiment_cli(["--algo", "dqn", "--task", "CartPole-v1"]),
        "HostCollector(act_on_host)": lambda: HostCollector(
            algo, make_atari_env("fake", 1, 1, env_fn=FakeAtariEnv)[0], act_on_host=True),
        "AsyncHostCollector": lambda: AsyncHostCollector(algo, AsyncHostVectorEnv([FakeAtariEnv])),
        "TicTacToe VectorEnv": lambda: VectorEnv(TicTacToe(), N_ENVS),
        "MultiAgentPolicyManager": lambda: MultiAgentPolicyManager([DQN(QNet(19, (8,), 9), Discrete(9))] * 2),
        "init_distributed": lambda: init_distributed("127.0.0.1:1", 2, 0),
        "make_mesh": lambda: make_mesh(1),
        "make_mesh2": lambda: make_mesh2(2),
        "global_mesh": lambda: global_mesh(),
        "Batch.to_torch": lambda: Batch(x=np.zeros(2)).to_torch(),
        "MinAtar VectorEnv": lambda: VectorEnv(Seaquest(), N_ENVS),
        "DistributedOffPolicyTrainer": lambda: DistributedOffPolicyTrainer(
            algo, col, col, ReplayBuffer(CAP, N_ENVS), max_epoch=1, step_per_epoch=1, step_per_collect=1),
        "DistributedOnPolicyTrainer": lambda: DistributedOnPolicyTrainer(
            algo, col, col, max_epoch=1, step_per_epoch=1, step_per_collect=1),
    }


@pytest.mark.parametrize("entry", ["VectorEnv", "ReplayBuffer.init", "DQN", "Collector", "OffPolicyTrainer",
                                   "PrioritizedReplayBuffer.init", "C51", "QRDQN", "REDQ", "DiscreteSAC", "BDQ",
                                   "DRQN", "OUNoise", "BC", "TD3BC", "BCQ", "CQL", "DiscreteBCQ", "DiscreteCQL",
                                   "DiscreteCRR", "buffer_from_d4rl", "OfflineTrainer", "HERReplayBuffer.init", "ICM",
                                   "GAIL", "PSRL", "ExperimentConfig().run", "experiment_cli",
                                   "HostCollector(act_on_host)", "AsyncHostCollector", "TicTacToe VectorEnv",
                                   "MultiAgentPolicyManager", "init_distributed", "make_mesh", "global_mesh",
                                   "DistributedOffPolicyTrainer", "DistributedOnPolicyTrainer", "make_mesh2",
                                   "Batch.to_torch", "MinAtar VectorEnv"])
def test_default_device_without_cuda_raises(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[entry]()


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import tianshou_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'tianshou_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'tianshou_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('tianshou_tpu_torch.')]))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 54


SLICE2_MODULES = ["envs.classic", "envs.wrappers", "envs.minatar", "networks.common"]
SLICE3_MODULES = ["ops.dist", "networks.continuous", "networks.convert", "algos.base", "algos.ddpg", "algos.sac",
                  "trainer.offpolicy", "utils.statistics", "envs.host", "utils.transfer", "collect.host_collector"]
SLICE4_MODULES = ["ops.returns", "utils.statistics", "envs.norm", "networks.continuous", "algos.pg", "algos.a2c",
                  "algos.ppo", "algos.npg", "collect.collector", "collect.host_collector", "trainer.onpolicy"]
SLICE5_MODULES = ["ops.segtree", "data.prio", "networks.discrete", "algos.c51", "algos.qrdqn"]
SLICE6_MODULES = ["networks.common", "networks.convert", "exploration.noise", "algos.base", "collect.collector",
                  "algos.redq", "algos.sac", "algos.bdq", "algos.drqn", "data.tree", "data.buffer", "envs.spaces"]
SLICE7_MODULES = ["data.persistence", "networks.continuous", "trainer.offline", "algos.offline", "data.her",
                  "algos.icm", "algos.gail", "algos.psrl", "algos.base", "algos.ddpg"]
SLICE8_MODULES = ["utils.repr", "data.stats", "utils.logger", "utils.checkpoint", "trainer.hooks", "trainer.offpolicy",
                  "trainer.onpolicy", "trainer.offline", "highlevel.config", "highlevel.env", "highlevel.module",
                  "highlevel.experiment", "highlevel.cli", "evaluation.aggregate", "evaluation.launcher",
                  "evaluation.plots", "evaluation", "networks.convert"]
SLICE11_MODULES = ["parallel", "parallel.mesh", "parallel.distributed", "trainer.distributed", "algos.base",
                   "algos.dqn", "algos.c51", "algos.qrdqn", "algos.ddpg", "algos.sac", "algos.redq", "collect.collector"]
SLICE9_MODULES = ["envs.atari", "envs.cpp_pool", "envs.finite", "envs.remote", "envs.tictactoe",
                  "envs.pettingzoo_env", "collect.async_collector", "algos.multiagent", "collect.host_collector",
                  "collect.collector", "trainer.offpolicy", "highlevel.env"]
OPTIONAL_PACKAGES = ["tensorboard", "cloudpickle", "joblib", "matplotlib", "tqdm", "wandb", "gymnasium", "h5py"]


def test_port_imports_slice2_modules_without_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE2_MODULES + SLICE3_MODULES + SLICE4_MODULES + SLICE5_MODULES + SLICE6_MODULES + SLICE7_MODULES + SLICE8_MODULES + SLICE9_MODULES + SLICE11_MODULES!r}:\n"
        "    importlib.import_module('tianshou_tpu_torch.' + m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'tianshou_tpu'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_slice7_modules_import_without_h5py():
    """No module of the port imports ``h5py`` when it is imported: with
    ``h5py`` unimportable, every slice-7 module imports and an ``.npz``
    dataset loads."""
    code = (
        "import importlib, sys\n"
        "import numpy as np\n"
        "sys.modules['h5py'] = None\n"
        f"for m in {SLICE7_MODULES!r}:\n"
        "    importlib.import_module('tianshou_tpu_torch.' + m)\n"
        "from tianshou_tpu_torch.data.persistence import buffer_from_d4rl\n"
        "d = {k: np.zeros((4, 3), np.float32) for k in ('observations', 'next_observations')}\n"
        "d.update(actions=np.zeros((4, 1), np.float32), rewards=np.zeros(4), terminals=np.zeros(4, bool))\n"
        "buf, st = buffer_from_d4rl(d, device='cpu')\n"
        "assert buf.capacity == 4\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_slice8_modules_import_without_optional_packages():
    """With every optional package unimportable, each slice-8 module
    imports and a small experiment runs on the CPU through the in-memory
    logger path: ``tensorboard`` is needed only where a
    ``TensorboardLogger`` is built, ``cloudpickle`` only by ``save``."""
    code = (
        "import importlib, sys\n"
        f"for name in {OPTIONAL_PACKAGES!r}:\n"
        "    sys.modules[name] = None\n"
        f"for m in {SLICE8_MODULES!r}:\n"
        "    importlib.import_module('tianshou_tpu_torch.' + m)\n"
        "from tianshou_tpu_torch.highlevel.config import SamplingConfig\n"
        "from tianshou_tpu_torch.highlevel.env import TorchEnvFactory\n"
        "from tianshou_tpu_torch.highlevel.experiment import DQNExperimentBuilder, ExperimentConfig\n"
        "r = DQNExperimentBuilder(TorchEnvFactory('CartPole-v1'), config=ExperimentConfig(device='cpu'),\n"
        "    sampling=SamplingConfig(num_epochs=1, step_per_epoch=64, step_per_collect=32, num_train_envs=4,\n"
        "    num_test_envs=2, episode_per_test=2, buffer_size=400)).build().run()\n"
        "assert r.info.env_step == 64, r.info\n"
        "from tianshou_tpu_torch.utils.logger import TensorboardLogger\n"
        "try:\n"
        "    TensorboardLogger('unused')\n"
        "except ImportError:\n"
        "    pass\n"
        "else:\n"
        "    raise AssertionError('TensorboardLogger built without tensorboard')\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {OPTIONAL_PACKAGES!r} and sys.modules[m])\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_slice9_modules_import_without_env_packages():
    """With gymnasium, pettingzoo and cv2 unimportable, every slice-9 module
    imports, the fake-ALE DeepMind chain runs (the warp is numpy) and
    TicTacToe steps: those packages are needed only to build a gymnasium
    env from a task id or to wrap a caller's PettingZoo env."""
    code = (
        "import importlib, sys\n"
        "import numpy as np, torch\n"
        "for name in ('gymnasium', 'pettingzoo', 'cv2'):\n"
        "    sys.modules[name] = None\n"
        f"for m in {SLICE9_MODULES!r}:\n"
        "    importlib.import_module('tianshou_tpu_torch.' + m)\n"
        "from tianshou_tpu_torch.envs.atari import FakeAtariEnv, make_atari_env\n"
        "train, test = make_atari_env('fake', 2, 1, env_fn=FakeAtariEnv)\n"
        "obs = train.reset(0)\n"
        "res, carry = train.step(np.ones(2, np.int64))\n"
        "assert obs.shape == (2, 4, 84, 84) and res.obs.dtype == np.uint8\n"
        "from tianshou_tpu_torch.envs.base import VectorEnv\n"
        "from tianshou_tpu_torch.envs.tictactoe import TicTacToe\n"
        "v = VectorEnv(TicTacToe(), 2, device='cpu')\n"
        "s, o = v.reset(torch.Generator())\n"
        "s, r, o = v.step(s, torch.tensor([4, 4]), torch.Generator())\n"
        "assert r.reward.shape == (2, 2)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'tianshou_tpu', 'gymnasium', 'pettingzoo', 'cv2') and sys.modules[m])\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_port_sources_name_no_jax_import():
    files = sorted((REPO / "tianshou_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tools" / "profile_superstep.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "optax", "orbax", "tianshou_tpu"), (path, name)


# -- (f) completeness ----------------------------------------------------------
# the JAX package's names (by module, relative to the package) that the port
# has under another name or module, or not at all, with the reason
RENAMED = {("envs/base.py", "JaxEnv"): "TorchEnv", ("envs/__init__.py", "JaxEnv"): "TorchEnv",
           ("highlevel/env.py", "JaxEnvFactory"): "TorchEnvFactory"}  # the port's envs are torch envs
NOT_PORTED = {("algos/offline.py", "DiscreteBCQTrainState"):  # defined and used nowhere, not even in JAX
              "unused in the JAX package"}
MOVED_MODULES = {"ops/pallas_gather.py": "ops/gather.py"}  # the Pallas kernel's wrapper beside the .cu kernel
SKIPPED_MODULES = {"utils/aot_cache.py": "XLA's compilation cache on the TPU backend has no H100 counterpart"}


def _public_names(path: pathlib.Path) -> set[str]:
    """The public top-level names a module defines (functions, classes and
    assignments not starting with ``_``) and those its ``__all__`` lists."""
    names = set()
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for target in node.targets if isinstance(node, ast.Assign) else [node.target]:
                if isinstance(target, ast.Name):
                    names.add(target.id)
                    if target.id == "__all__":
                        names.update(ast.literal_eval(node.value))
    return {n for n in names if not n.startswith("_")}


def _bound_names(path: pathlib.Path) -> set[str]:
    """Every name a module binds at its top level, imports included, and the
    names a package's ``__getattr__`` imports on first use (the keys of its
    ``_EXPORTS``; the test below resolves each)."""
    names = set()
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for target in node.targets if isinstance(node, ast.Assign) else [node.target]:
                if isinstance(target, ast.Name):
                    names.add(target.id)
                    if target.id == "_EXPORTS":
                        names.update(ast.literal_eval(node.value))
        elif isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Import):
            names.update(a.asname or a.name.split(".")[0] for a in node.names)
    return names


def test_every_jax_module_and_name_has_a_counterpart():
    jax_root, port_root = REPO / "tianshou_tpu", REPO / "tianshou_tpu_torch"
    missing, checked = [], 0
    for path in sorted(jax_root.rglob("*.py")):
        rel = path.relative_to(jax_root).as_posix()
        if rel in SKIPPED_MODULES:
            continue
        port = port_root / MOVED_MODULES.get(rel, rel)
        if not port.exists():
            missing.append((rel, "<module>"))
            continue
        have = _bound_names(port)
        for name in sorted(_public_names(path)):
            checked += 1
            if (rel, name) in NOT_PORTED:
                continue
            if RENAMED.get((rel, name), name) not in have:
                missing.append((rel, name))
    assert not missing, missing
    assert checked > 350, checked
    # every exception is still needed: the JAX name exists, the port's does
    for (rel, name), new in RENAMED.items():
        assert name in _public_names(jax_root / rel) and new in _bound_names(port_root / rel), (rel, name)
    for rel, name in NOT_PORTED:
        assert name in _public_names(jax_root / rel) and name not in _bound_names(port_root / rel)
    for rel in SKIPPED_MODULES:
        assert (jax_root / rel).exists() and not (port_root / rel).exists()
    for rel, new in MOVED_MODULES.items():
        assert (jax_root / rel).exists() and not (port_root / rel).exists() and (port_root / new).exists()


@pytest.mark.parametrize("package", ["algos", "collect", "data", "envs", "networks", "trainer"])
def test_package_names_resolve_like_jax(package):
    """Each subpackage lists the JAX subpackage's names and resolves every
    one to the object its module defines."""
    import importlib

    port = importlib.import_module(f"tianshou_tpu_torch.{package}")
    ref = importlib.import_module(f"tianshou_tpu.{package}")
    assert sorted(RENAMED.get((f"{package}/__init__.py", n), n) for n in ref.__all__) == sorted(port.__all__)
    for name in port.__all__:
        obj = getattr(port, name)
        assert getattr(importlib.import_module(obj.__module__), name) is obj, name
    with pytest.raises(AttributeError):
        port.no_such_name  # noqa: B018


# -- (e) the paths of slice 2 -------------------------------------------------
from tianshou_tpu.envs.classic import CartPole as JaxCartPole  # noqa: E402
from tianshou_tpu.envs.classic import CartPoleState as JaxCartPoleState  # noqa: E402
from tianshou_tpu.envs.minatar import Breakout as JaxBreakout  # noqa: E402
from tianshou_tpu.networks.common import QNet as JaxQNet  # noqa: E402
from tianshou_tpu_torch.envs.classic import CartPole, CartPoleState  # noqa: E402
from tianshou_tpu_torch.envs.minatar import Breakout  # noqa: E402
from tianshou_tpu_torch.networks.common import QNet  # noqa: E402

CART0 = np.array([0.03, -0.02, 0.04, 0.01], np.float32)


class _JaxCart(JaxCartPole):
    def reset(self, key):
        s = JaxCartPoleState(*map(jnp.asarray, CART0), jnp.zeros((), jnp.int32))
        return s, self._obs(s)


class _Cart(CartPole):
    def reset(self, generator, num_envs, device):
        v = torch.from_numpy(CART0).to(device).repeat(num_envs, 1)
        s = CartPoleState(*v.unbind(1), torch.zeros(num_envs, dtype=torch.int32, device=device))
        return s, self._obs(s)


class _JaxPixel(JaxPixelEnv):
    def reset(self, key):
        s = JaxPixelState(jnp.zeros((), jnp.int32), jnp.asarray(5, jnp.int32))
        return s, self._frame(s.t, s.seed)


class _Pixel(SyntheticPixelEnv):
    def reset(self, generator, num_envs, device):
        s = SyntheticPixelState(torch.zeros(num_envs, dtype=torch.int32, device=device),
                                torch.full((num_envs,), 5, dtype=torch.int32, device=device))
        return s, self.frame(s.t, s.seed)


class _JaxBreakout(JaxBreakout):
    def reset(self, key):
        st, _ = super().reset(key)
        st = st._replace(ball_x=jnp.asarray(0, jnp.int32), trail_x=jnp.asarray(0, jnp.int32),
                         ball_dx=jnp.asarray(1, jnp.int32))
        return st, self._obs(st)


class _Breakout(Breakout):
    def reset(self, generator, num_envs, device):
        st = self.initial_state(torch.zeros(num_envs, dtype=torch.bool, device=device))
        return st, self._obs(st)


def _slice2_case(case):
    """``(jax env, jax net, torch env, torch net, buffer options, injected
    start states as (jax, torch) or None)``."""
    if case == "cartpole":
        rng = np.random.default_rng(5)
        start = rng.uniform(-0.04, 0.04, (4, N_ENVS)).astype(np.float32)
        t0 = np.array([0, 3, 6], np.int32)
        jstart = JaxCartPoleState(*map(jnp.asarray, start), jnp.asarray(t0))
        tstart = CartPoleState(*map(torch.from_numpy, start), torch.from_numpy(t0))
        return (_JaxCart(), JaxQNet((32, 32), 2), _Cart(), QNet(4, (32, 32), 2), {}, (jstart, tstart))
    if case == "minatar":
        enc = ({"compute_dtype": jnp.float32}, {"compute_dtype": torch.float32})
        return (_JaxBreakout(sticky_prob=0.0), JaxConvQNet(3, "minatar", enc[0]), _Breakout(sticky_prob=0.0),
                ConvQNet((10, 10, 4), 3, "minatar", enc[1]), {}, None)
    enc = ({"compute_dtype": jnp.float32}, {"compute_dtype": torch.float32})
    start = (JaxPixelState(jnp.zeros(N_ENVS, jnp.int32), jnp.asarray([11, 222, 3333], jnp.int32)),
             SyntheticPixelState(torch.zeros(N_ENVS, dtype=torch.int32), torch.tensor([11, 222, 3333], dtype=torch.int32)))
    options = dict(stack_num=2, save_only_last_obs=True, ignore_obs_next=True)
    return (_JaxPixel(H, W, 2, num_actions=A, episode_len=7, channel_first=True),
            JaxConvQNet(A, "nature", enc[0]),
            _Pixel(H, W, 2, num_actions=A, episode_len=7, channel_first=True),
            ConvQNet((2, H, W), A, "nature", enc[1]), options, start)


@pytest.mark.parametrize("case", ["cartpole", "minatar", "stacked-pixels"])
def test_slice2_paths_match_jax(case):
    jenv, jnet, tenv, tnet, options, start = _slice2_case(case)
    jvenv, tvenv = JaxVectorEnv(jenv, N_ENVS), VectorEnv(tenv, N_ENVS, device="cpu")
    jbuf, tbuf = JaxReplayBuffer(CAP, N_ENVS, **options), ReplayBuffer(CAP, N_ENVS, **options)
    kw = dict(lr=1e-3, gamma=0.9, n_step=N_STEP, target_update_freq=2)
    jalgo = JaxDQN(jnet, jenv.action_space, **kw)
    talgo = DQN(tnet, tenv.action_space, device="cpu", **kw)
    jcol, tcol = JaxCollector(jalgo, jvenv, jbuf), Collector(talgo, tvenv, tbuf, device="cpu")
    jcs, tcs = jcol.reset(jax.random.key(0)), tcol.reset(torch.Generator().manual_seed(0))
    if start is not None:
        jcs = jcs.replace(env_state=start[0], obs=jax.vmap(jenv._frame if hasattr(jenv, "_frame") else jenv._obs)(
            *((start[0].t, start[0].seed) if hasattr(jenv, "_frame") else (start[0],))))
        tcs.env_state = start[1]
        tcs.obs = tenv.frame(start[1].t, start[1].seed) if hasattr(tenv, "frame") else tenv._obs(start[1])
    np.testing.assert_array_equal(tcs.obs.numpy(), np.asarray(jcs.obs))
    jts = jalgo.init(jax.random.key(0 if case == "cartpole" else 1), jcs.obs[0])
    if case == "minatar":
        # a freshly drawn head ranks the actions alike on every Breakout
        # screen (the brick wall dominates the features); centring the
        # Q-values on the first screen makes the greedy actions vary
        params = jax.device_get(jts.params)
        head = params["params"]["Dense_0"]
        head["bias"] = head["bias"] - np.asarray(jnet.apply(params, jcs.obs[:1]))[0]
        jts = jts.replace(params=params, target_params=params, opt_state=jalgo.optimizer.init(params))
    tts = talgo.init(torch.Generator().manual_seed(1))
    sd = params_from_flax(jax.device_get(jts.params))
    tts.online.load_state_dict(sd)
    tts.target.load_state_dict(sd)
    jbs = jbuf.init(jcol.example_transition(jts, jcs))
    tbs = tbuf.init(tcol.example_transition(tts, tcs), device="cpu")

    jseg = jax.jit(jax_rollout_segment(jalgo, jvenv, jbuf, SEG, explore=False, record_traj=False))
    jcs, jbs, jout = jseg(jts, jcs, jbs, 0.0)
    tcs, tbs, tout = rollout_segment(talgo, tvenv, tbuf, SEG, explore=False)(tts, tcs, tbs, 0.0)
    np.testing.assert_array_equal(tbs.storage["act"].numpy(), np.asarray(jbs.storage["act"]))
    print(case, "actions", np.bincount(np.asarray(jbs.storage["act"]).ravel()), "episode ends",
          int(np.asarray(jout["done"]).sum()))
    assert len(np.unique(np.asarray(jbs.storage["act"]))) > 1
    assert int(np.asarray(jout["done"]).sum()) > 0  # the segment crosses an auto-reset
    np.testing.assert_array_equal(tout["done"].numpy(), np.asarray(jout["done"]))
    for k in jbs.storage:
        ref, got = np.asarray(jbs.storage[k]), tbs.storage[k].numpy()
        assert got.shape == ref.shape, k
        if case == "cartpole" and got.dtype == np.float32:
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=k)
    if options:
        assert tbs.storage["obs"].shape == (N_ENVS, CAP, H, W) and "obs_next" not in tbs.storage

    rng = np.random.default_rng(7)
    env_idx, pos = rng.integers(0, N_ENVS, K * BATCH), rng.integers(0, CAP, K * BATCH)
    ones = np.ones(K * BATCH, np.float32)
    jbuf.sample_with_weights = lambda st, key, b: (
        jnp.asarray(env_idx, jnp.int32), jnp.asarray(pos, jnp.int32), jnp.asarray(ones))
    tbuf.sample_with_weights = lambda st, g, b: (
        torch.from_numpy(env_idx), torch.from_numpy(pos), torch.from_numpy(ones))
    jts, _, jm = jax_build_update_scan(jalgo, jbuf, BATCH, K)(jts, jbs, jax.random.key(2))
    tts, _, tm = build_update_scan(talgo, tbuf, BATCH, K)(tts, tbs, torch.Generator())
    for k in ("loss", "td_abs_mean"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    for mod, flax_params in ((tts.online, jts.params), (tts.target, jts.target_params)):
        ref = params_from_flax(jax.device_get(flax_params))
        for name, val in mod.state_dict().items():
            np.testing.assert_allclose(val.numpy(), ref[name].numpy(), rtol=1e-4, atol=1e-5, err_msg=name)
