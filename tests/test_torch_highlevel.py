"""The port's high-level API (tianshou_tpu_torch.highlevel: config, env,
module, experiment and cli) against the JAX package, on the CPU.

(a) Every builder of ``tests/test_highlevel.py`` (6 discrete, 7
    continuous) and the offline builders (BC, CQL, TD3BC, through
    ``with_offline_data``) run an experiment on the port at the JAX test's
    ``SamplingConfig`` with ``device="cpu"``, and the trainer each wires has
    the JAX trainer's settings (the JAX experiment built with its trainer's
    ``run`` stubbed): epochs, steps a collect, updates a superstep, batch,
    ring capacity and envs, warm-up, ``train_param_fn(0, 0)``,
    ``test_param`` and every scalar hyperparameter the two algorithms both
    name.
(b) The ``default_*`` factories on CartPole, Pendulum, MinAtar Breakout and
    ``SyntheticPixelEnv(84, 84, 4)`` give the counterpart class; with the
    Flax parameters carried over by ``networks/convert.py`` the forwards
    agree at rtol 1e-5 / atol 1e-6 in float32, and within 2e-2 of the
    output scale for the bf16 conv nets (the conv parity tests' bound).
(c) Persistence (``save`` / ``from_directory`` through cloudpickle; the
    pickle holds no tensor and no ``torch.device``), the seeded collection
    and its launcher, the pixel builder with the watch loop.
(d) The CLI: the registry's keys are the JAX registry's, each algorithm's
    flags are the JAX flags plus ``--experiment.device``, and ports of the
    JAX CLI tests run with ``--experiment.device cpu``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tianshou_tpu.highlevel import cli as jcli
from tianshou_tpu.highlevel import env as jenv
from tianshou_tpu.highlevel import experiment as jex
from tianshou_tpu.highlevel import module as jmod
from tianshou_tpu_torch.evaluation.aggregate import AggregatedResult
from tianshou_tpu_torch.evaluation.launcher import SequentialExpLauncher
from tianshou_tpu_torch.highlevel import cli as tcli
from tianshou_tpu_torch.highlevel import env as tenv
from tianshou_tpu_torch.highlevel import experiment as tex
from tianshou_tpu_torch.highlevel import module as tmod
from tianshou_tpu_torch.highlevel.config import SamplingConfig
from tianshou_tpu_torch.networks.convert import load_flax_params

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test, as the threshold copies run: the suite runs in
    several worker processes, and their threads would share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_SMOKE_ONPOLICY = dict(
    num_epochs=1, step_per_epoch=512, step_per_collect=256,
    repeat_per_collect=1, batch_size=64, num_train_envs=4, num_test_envs=2,
    episode_per_test=2,
)
_SMOKE_OFFPOLICY = dict(
    num_epochs=1, step_per_epoch=200, step_per_collect=40, batch_size=32,
    num_train_envs=4, num_test_envs=2, buffer_size=2000,
    update_per_step=0.1, start_timesteps=100, episode_per_test=2,
)
_SMOKE_OFFLINE = dict(num_epochs=1, step_per_epoch=100, batch_size=32, num_test_envs=2, episode_per_test=2)

BUILDERS = [
    ("DQNExperimentBuilder", _SMOKE_OFFPOLICY, "CartPole-v1"),
    ("IQNExperimentBuilder", _SMOKE_OFFPOLICY, "CartPole-v1"),
    ("DiscreteSACExperimentBuilder", _SMOKE_OFFPOLICY, "CartPole-v1"),
    ("PPOExperimentBuilder", _SMOKE_ONPOLICY, "CartPole-v1"),
    ("A2CExperimentBuilder", _SMOKE_ONPOLICY, "CartPole-v1"),
    ("PGExperimentBuilder", _SMOKE_ONPOLICY, "CartPole-v1"),
    ("SACExperimentBuilder", _SMOKE_OFFPOLICY, "Pendulum-v1"),
    ("TD3ExperimentBuilder", _SMOKE_OFFPOLICY, "Pendulum-v1"),
    ("DDPGExperimentBuilder", _SMOKE_OFFPOLICY, "Pendulum-v1"),
    ("REDQExperimentBuilder", _SMOKE_OFFPOLICY, "Pendulum-v1"),
    ("PPOExperimentBuilder", _SMOKE_ONPOLICY, "Pendulum-v1"),
    ("NPGExperimentBuilder", _SMOKE_ONPOLICY, "Pendulum-v1"),
    ("TRPOExperimentBuilder", _SMOKE_ONPOLICY, "Pendulum-v1"),
]
OFFLINE_BUILDERS = ["BCExperimentBuilder", "CQLExperimentBuilder", "TD3BCExperimentBuilder"]


def _jax_trainer(builder_name, sampling, task, offline_data=None):
    """The JAX experiment's trainer, built by ``run()`` with the trainer's
    own ``run`` stubbed, and the JAX experiment's config after it."""
    from tianshou_tpu.data.stats import InfoStats
    from tianshou_tpu.trainer import offline, offpolicy, onpolicy

    captured = {}

    def fake_run(self):
        captured["trainer"] = self
        self.train_state = None
        return InfoStats(0, 0, 0, 0.0, 0.0, 0.0)

    builder = getattr(jex, builder_name)(
        jenv.JaxEnvFactory(task), config=jex.ExperimentConfig(logger="none", checkpoint_best=False),
        sampling=SamplingConfigJ(**sampling)).with_seed(0)
    if offline_data is not None:
        builder.with_offline_data(offline_data)
    exp = builder.build()
    patches = [(cls, cls.run) for cls in (offpolicy.OffPolicyTrainer, onpolicy.OnPolicyTrainer, offline.OfflineTrainer)]
    try:
        for cls, _ in patches:
            cls.run = fake_run
        exp.run()
    finally:
        for cls, run in patches:
            cls.run = run
    return captured["trainer"], exp.config


def SamplingConfigJ(**kw):
    from tianshou_tpu.highlevel.config import SamplingConfig as JSamplingConfig

    return JSamplingConfig(**kw)


def _scalars(obj) -> dict:
    return {k: v for k, v in vars(obj).items()
            if not k.startswith("_") and isinstance(v, (bool, int, float, str, type(None)))}


def _assert_same_settings(tt, jt, tcfg, jcfg):
    names = ["max_epoch", "step_per_epoch", "segment_len", "steps_per_segment", "updates_per_segment",
             "repeat_per_collect", "batch_size", "episode_per_test", "warmup_steps", "warmup_random",
             "test_param", "update_per_epoch", "updates_per_superstep"]
    compared = [name for name in names if hasattr(jt, name)]
    assert "max_epoch" in compared and "batch_size" in compared
    for name in compared:
        assert getattr(tt, name) == getattr(jt, name), name
    if hasattr(jt, "train_param_fn"):
        assert tt.train_param_fn(0, 0) == jt.train_param_fn(0, 0)
    if hasattr(jt, "buffer") and hasattr(jt, "train_collector"):
        for name in ("capacity", "num_envs", "stack_num"):
            assert getattr(tt.buffer, name) == getattr(jt.buffer, name), name
        assert type(tt.buffer).__name__ == type(jt.buffer).__name__
    if hasattr(jt, "train_collector"):
        assert tt.train_collector.venv.num_envs == jt.train_collector.venv.num_envs
    assert tt.test_collector.venv.num_envs == jt.test_collector.venv.num_envs
    assert tcfg.test_param == jcfg.test_param
    # every scalar hyperparameter the two algorithms both name
    ta, ja = _scalars(tt.algo), _scalars(jt.algo)
    shared = sorted(set(ta) & set(ja))
    assert shared, (sorted(ta), sorted(ja))
    # (a float the JAX package computes in float32, DiscreteSAC's target
    # entropy, matches to float32 rounding)
    assert {k: ta[k] for k in shared} == {k: pytest.approx(ja[k], rel=1e-7) if isinstance(ja[k], float) else ja[k]
                                          for k in shared}
    assert type(tt.algo).__name__ == type(jt.algo).__name__


def _port_run(builder_name, sampling, task, offline_data=None, **config):
    builder = getattr(tex, builder_name)(
        tenv.TorchEnvFactory(task),
        config=tex.ExperimentConfig(logger="none", checkpoint_best=False, device=CPU, **config),
        sampling=SamplingConfig(**sampling)).with_seed(0)
    if offline_data is not None:
        builder.with_offline_data(offline_data)
    exp = builder.build()
    return exp, exp.run()


@pytest.mark.parametrize("builder_name,sampling,task", BUILDERS,
                         ids=[f"{b[:-17]}-{t.split('-')[0]}" for b, _, t in BUILDERS])
def test_builder_runs_with_the_jax_settings(builder_name, sampling, task):
    exp, result = _port_run(builder_name, sampling, task)
    assert result.info.env_step > 0
    assert np.isfinite(result.info.best_reward)
    jt, jcfg = _jax_trainer(builder_name, sampling, task)
    _assert_same_settings(result.world.trainer, jt, exp.config, jcfg)


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


@pytest.mark.parametrize("builder_name", OFFLINE_BUILDERS)
def test_offline_builder_runs_with_the_jax_settings(builder_name, pendulum_dataset):
    exp, result = _port_run(builder_name, _SMOKE_OFFLINE, "Pendulum-v1", offline_data=pendulum_dataset)
    assert result.info.gradient_step >= 100
    assert np.isfinite(result.info.best_reward)
    jt, jcfg = _jax_trainer(builder_name, _SMOKE_OFFLINE, "Pendulum-v1", offline_data=pendulum_dataset)
    _assert_same_settings(result.world.trainer, jt, exp.config, jcfg)


# -- (b) the default factories -------------------------------------------------
def _envs(name):
    if name == "synthetic":
        from tianshou_tpu.envs.synthetic import SyntheticPixelEnv as JSynthetic
        from tianshou_tpu_torch.envs.synthetic import SyntheticPixelEnv

        je, te = JSynthetic(84, 84, 4), SyntheticPixelEnv(84, 84, 4)
    else:
        from tianshou_tpu.envs.classic import make_env as jmake
        from tianshou_tpu_torch.envs.classic import make_env as tmake

        je, te = jmake(name), tmake(name)
    return (jenv.Environments(None, None, je.observation_space, je.action_space, "jax"),
            tenv.Environments(None, None, te.observation_space, te.action_space, "torch"))


FACTORIES = [
    ("CartPole-v1", "default_q_network", dict(hidden_sizes=(32, 16)), "QNet"),
    ("CartPole-v1", "default_q_network", dict(hidden_sizes=(32,), dueling=True), "DuelingQNet"),
    ("CartPole-v1", "default_actor", dict(hidden_sizes=(32,)), "QNet"),
    ("CartPole-v1", "default_value_network", dict(hidden_sizes=(32, 32)), "ValueNet"),
    ("Pendulum-v1", "default_actor", dict(hidden_sizes=(32,)), "GaussianActor"),
    ("Pendulum-v1", "default_actor", dict(hidden_sizes=(32,), conditioned_sigma=True), "GaussianActor"),
    ("Pendulum-v1", "default_actor", dict(hidden_sizes=(32,), deterministic=True), "DeterministicActor"),
    ("Pendulum-v1", "default_value_network", dict(hidden_sizes=(16,)), "ValueNet"),
    ("Pendulum-v1", "default_continuous_critic", dict(hidden_sizes=(32, 32)), "CriticEnsemble"),
    ("minatar-breakout", "default_q_network", dict(hidden_sizes=(32,)), "ConvQNet"),
    ("minatar-breakout", "default_q_network", dict(dueling=True), "ConvDuelingQNet"),
    ("minatar-breakout", "default_value_network", {}, "ConvValueNet"),
    ("synthetic", "default_q_network", {}, "ConvQNet"),
]


@pytest.mark.parametrize("task,factory,kw,cls", FACTORIES,
                         ids=[f"{t.split('-')[0]}-{f[8:]}-{c}-{i}" for i, (t, f, _, c) in enumerate(FACTORIES)])
def test_default_factories_match_flax(task, factory, kw, cls):
    jenvs, tenvs = _envs(task)
    jnet, tnet = getattr(jmod, factory)(jenvs, **kw), getattr(tmod, factory)(tenvs, **kw)
    assert type(tnet).__name__ == type(jnet).__name__ == cls
    assert jmod.is_pixel_space(jenvs) == tmod.is_pixel_space(tenvs)
    if hasattr(jnet, "encoder"):
        assert tnet.encoder.__class__.__name__ == {"minatar": "MinAtarCNN", "nature": "NatureCNN"}[jnet.encoder]
    rng = np.random.default_rng(0)
    shape = tenvs.observation_space.shape
    if tmod.is_pixel_space(tenvs):
        obs = rng.integers(0, 256 if task == "synthetic" else 2, (5,) + shape).astype(
            np.uint8 if task == "synthetic" else np.float32)
    else:
        obs = rng.normal(size=(5,) + shape).astype(np.float32)
    args = [obs]
    if factory == "default_continuous_critic":
        args.append(rng.uniform(-1, 1, (5, tenvs.action_space.shape[0])).astype(np.float32))
    params = jnet.init(jax.random.key(0), *args)
    load_flax_params(tnet, jax.device_get(params))
    with torch.no_grad():
        got = tnet(*(torch.as_tensor(a) for a in args))
    ref = jnet.apply(params, *args)
    got, ref = jax.tree.leaves(jax.tree.map(np.asarray, (got,))), jax.tree.leaves((ref,))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        r = np.asarray(r, np.float32)
        if tmod.is_pixel_space(tenvs):  # bf16 compute in both
            np.testing.assert_allclose(np.asarray(g, np.float32), r, rtol=0, atol=2e-2 * np.abs(r).max())
        else:
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6)
    # the conv nets keep bf16 compute, so a pixel presample goes through
    # gather_rows_cast
    if tmod.is_pixel_space(tenvs):
        assert tnet.input_dtype == torch.bfloat16


# -- (c) persistence, collections, the pixel builder ------------------------------
def test_experiment_persistence_roundtrip_holds_no_tensor(tmp_path):
    cloudpickle = pytest.importorskip("cloudpickle")
    exp = (tex.DQNExperimentBuilder(
        tenv.TorchEnvFactory("CartPole-v1"),
        config=tex.ExperimentConfig(logger="none", checkpoint_best=False, device=CPU),
        sampling=SamplingConfig(**_SMOKE_OFFPOLICY)).with_seed(3).build())
    exp.run()  # sets the builder's lambda train_param_fn, as in the JAX package
    found = []

    class Spy(cloudpickle.CloudPickler):
        def reducer_override(self, obj):
            if isinstance(obj, (torch.Tensor, torch.device)):
                found.append(type(obj).__name__)
            return super().reducer_override(obj)

    import io

    Spy(io.BytesIO()).dump(exp)
    assert not found, found
    exp.save(str(tmp_path))
    exp2 = tex.Experiment.from_directory(str(tmp_path))
    assert exp2.config.seed == 3 and exp2.config.device == CPU
    result = exp2.run()
    assert result.info.env_step > 0


def test_seeded_collection_and_launcher():
    builder = tex.DQNExperimentBuilder(
        tenv.TorchEnvFactory("CartPole-v1"),
        config=tex.ExperimentConfig(logger="none", checkpoint_best=False, device=CPU),
        sampling=SamplingConfig(**_SMOKE_OFFPOLICY),
    )
    exps = builder.build_seeded_collection(3)
    assert [e.config.seed for e in exps] == [0, 1, 2]
    result = SequentialExpLauncher().launch(exps)
    assert len(result.successes) == 3 and not result.failures
    agg = AggregatedResult.from_launch(result)
    assert np.isfinite(agg.iqm)
    assert agg.ci_low <= agg.iqm <= agg.ci_high


def test_pixel_dqn_builder_zero_networks_and_watch():
    """The default factories give a MinAtar env a conv Q-net, and the watch
    loop reports its episodes."""
    from tianshou_tpu_torch.networks.conv import ConvQNet

    result = (
        tex.DQNExperimentBuilder(
            tenv.TorchEnvFactory("minatar-breakout"),
            config=tex.ExperimentConfig(logger="none", checkpoint_best=False, watch=True, watch_num_episodes=2,
                                        device=CPU),
            sampling=SamplingConfig(num_epochs=1, step_per_epoch=256, step_per_collect=64, batch_size=32,
                                    num_train_envs=4, num_test_envs=2, episode_per_test=2, buffer_size=2000,
                                    start_timesteps=128),
        )
        .with_dqn_params(tex.DQNParams(hidden_sizes=(32,), n_step=1))
        .build()
        .run()
    )
    assert isinstance(result.world.algo.network, ConvQNet)
    assert result.watch_stats is not None
    assert result.watch_stats.n_collected_episodes == 2
    assert result.world.envs.backend == "torch"


def test_tensorboard_experiment_saves_checkpoint_and_itself(tmp_path):
    pytest.importorskip("tensorboard")
    pytest.importorskip("cloudpickle")
    from tianshou_tpu_torch.utils.checkpoint import restore_checkpoint

    exp = tex.DQNExperimentBuilder(
        tenv.TorchEnvFactory("CartPole-v1"),
        config=tex.ExperimentConfig(logger="tensorboard", persistence_base_dir=str(tmp_path), device=CPU),
        sampling=SamplingConfig(**_SMOKE_OFFPOLICY)).build()
    result = exp.run(name="run0")
    assert result.log_dir == str(tmp_path / "run0")
    restored = restore_checkpoint(str(tmp_path / "run0" / "checkpoint"), result.train_state)
    assert restored.step == result.train_state.step
    assert tex.Experiment.from_directory(result.log_dir).config.device == CPU


def test_env_factories_raise_for_what_is_not_ported():
    # RemoteEnvFactory is ported (slice 9): it builds, and connecting to an
    # address where no farm listens raises at once
    factory = tenv.RemoteEnvFactory(["127.0.0.1:1"], ["127.0.0.1:2"])
    with pytest.raises(ConnectionRefusedError):
        factory.create_envs(0, 0, device=CPU)
    # the four later MinAtar games are ported (slice 12): they build
    from tianshou_tpu_torch.envs.minatar import Seaquest

    envs = tenv.TorchEnvFactory("minatar-seaquest").create_envs(2, 1, device=CPU)
    assert isinstance(envs.train_venv.env, Seaquest) and envs.observation_space.shape == (10, 10, 9)
    with pytest.raises(KeyError):
        tenv.TorchEnvFactory("NoSuchEnv-v0")


# -- (d) the CLI ---------------------------------------------------------------------
def _flags(parser) -> set[str]:
    return {s for a in parser._actions for s in a.option_strings}


def test_cli_registry_and_flags_match_jax():
    assert set(tcli._registry()) == set(jcli._registry())
    assert tcli.OFFLINE_ALGOS == jcli.OFFLINE_ALGOS
    for algo in jcli._registry():
        assert _flags(tcli.build_parser(algo)) == _flags(jcli.build_parser(algo)) | {"--experiment.device"}, algo
        tparams, jparams = tcli._registry()[algo][1], jcli._registry()[algo][1]
        assert [f.name for f in dataclasses.fields(tparams)] == [f.name for f in dataclasses.fields(jparams)]
        assert tparams() == tparams(**dataclasses.asdict(jparams())), algo  # the same defaults


def test_cli_registry_every_algo_parses_and_builds(tmp_path):
    """Every registry entry parses its flags and builds its algorithm from
    the params defaults."""
    from tianshou_tpu_torch.envs.classic import CartPole, Pendulum

    discrete_only = {"dqn", "iqn", "discrete_sac"}
    cart, pend = CartPole(), Pendulum()
    registry = tcli._registry()
    assert tcli.OFFLINE_ALGOS <= set(registry)
    for algo, (builder_t, params_t, setter) in registry.items():
        task = "CartPole-v1" if algo in discrete_only else "Pendulum-v1"
        argv = ["--algo", algo, "--task", task, "--experiment.device", CPU]
        if algo in tcli.OFFLINE_ALGOS:
            argv += ["--dataset", str(tmp_path / "d.h5")]
        ns = tcli.build_parser(algo).parse_args(argv)
        params = tcli.dataclass_from_args(params_t, ns, "params")
        env = cart if algo in discrete_only else pend
        envs = tenv.Environments(None, None, env.observation_space, env.action_space, "torch")
        builder = builder_t(tenv.TorchEnvFactory(task),
                            config=tcli.dataclass_from_args(tex.ExperimentConfig, ns, "experiment"))
        getattr(builder, setter)(params)
        if algo in tcli.OFFLINE_ALGOS:
            builder.with_offline_data(str(tmp_path / "d.h5"))
        assert isinstance(builder.build(), tex.Experiment)
        alg = builder._make_algo(envs)
        assert alg.device == torch.device(CPU), algo


def test_cli_offline_algo_end_to_end(pendulum_dataset):
    result = tcli.experiment_cli(
        ["--algo", "bc", "--task", "Pendulum-v1", "--dataset", pendulum_dataset,
         "--sampling.num_epochs", "1", "--sampling.step_per_epoch", "50",
         "--sampling.batch_size", "32", "--sampling.num_test_envs", "2",
         "--sampling.episode_per_test", "2", "--params.hidden_sizes", "16", "--experiment.device", CPU]
    )
    assert result.info.gradient_step >= 50


def test_cli_offline_requires_dataset():
    with pytest.raises(SystemExit, match="dataset"):
        tcli.experiment_cli(["--algo", "cql", "--task", "Pendulum-v1", "--experiment.device", CPU])


def test_cli_tier_runs_and_overrides_fields():
    ns = tcli.build_parser("dqn").parse_args(
        ["--task", "CartPole-v1", "--sampling.num_epochs", "2",
         "--sampling.step_per_epoch", "1024", "--sampling.num_train_envs",
         "8", "--params.lr", "5e-4", "--experiment.seed", "7", "--experiment.device", CPU]
    )
    sc = tcli.dataclass_from_args(SamplingConfig, ns, "sampling")
    assert sc.num_epochs == 2 and sc.num_train_envs == 8
    assert tcli.dataclass_from_args(tex.ExperimentConfig, ns, "experiment").device == CPU
    result = tcli.experiment_cli(
        ["--algo", "dqn", "--task", "CartPole-v1",
         "--sampling.num_epochs", "1", "--sampling.step_per_epoch", "1024",
         "--sampling.num_train_envs", "8", "--sampling.buffer_size", "2048",
         "--experiment.seed", "7", "--experiment.device", CPU]
    )
    assert result.info.env_step >= 1024
