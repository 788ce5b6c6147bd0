"""The port's example scripts against the JAX package's, part (b): wiring.

For each script and a few of its flag sets, the JAX script's ``main`` runs
with ``--platform cpu`` until it calls its trainer's ``run``
(``OffPolicyTrainer``, ``OnPolicyTrainer`` and ``OfflineTrainer``'s ``run``
patched to capture the trainer and raise; ``highlevel_dqn``'s experiment
builds its trainer inside ``run``, so the same patch captures it there), and
the port module's ``build`` gets the same flags with ``--device cpu``.  The
two trainers must agree on:

- every scalar setting both name (epochs, steps an epoch and a collect, the
  segment split, updates, batch, test episodes, warm-up, seed, ...);
- ``train_param_fn`` at a few (epoch, env step) points and ``stop_fn`` at a
  few returns;
- the buffer's class, capacity, env count and memory options, and each
  collector's env class and env count;
- the logger's class, and every scalar hyperparameter both algorithms name;
- the optimizer, where the JAX algorithm holds one (the DQN family and the
  on-policy family, learning-rate schedules and RMSprop included): five
  steps from the same parameters and gradients, within 5e-7 (float32);
- the networks (``network``, ``actor``, ``critic``): Flax parameters of
  the shapes ``init`` gives, drawn from a seed, load into the port's module
  through ``networks/convert.py`` (strict, so every shape agrees); at each
  script's first flag set, its defaults, one forward on the same inputs
  agrees within rtol 1e-5 / atol 1e-6, or, for the conv nets, which compute
  in bf16 on both sides, within 2e-2 of the output's scale (the bound of
  ``tests/test_torch_highlevel.py``).

The real gymnasium, MuJoCo and Box2D envs build here; Atari runs on
``FakeAtariEnv`` (``--fake-ale``).
"""

import sys

import jax
import numpy as np
import optax
import pytest
import torch
from test_torch_examples_flags import _one_torch_thread, jax_main, port_module  # noqa: F401

from tianshou_tpu_torch.algos.ddpg import adam
from tianshou_tpu_torch.networks.convert import load_flax_params

STOP_POINTS = [-1e9, -300.0, -250.0, -249.9, 0.0, 10.0, 194.9, 195.0, 200.0, 300.0, 1e9]
PARAM_POINTS = [(0, 0), (1, 777), (2, 150_000), (9, 3_000_000)]

# flag sets of each script: the defaults, the variants, small budgets where
# a learning-rate schedule spans them (so that five steps show its slope)
VARIANTS = {
    "atari_dqn": [["--fake-ale"], ["--fake-ale", "--stop-reward", "20", "--seed", "3", "--training-num", "5"]],
    "box2d_dqn": [[], ["--stop-reward", "0", "--seed", "2"]],
    "box2d_sac": [[], ["--hardcore", "--no-stop"]],
    "cpp_pool_dqn": [[], ["--num-envs", "4", "--seed", "7"]],
    "dqn_cartpole": [[], ["--seed", "5", "--eps-train", "0.3", "--num-envs", "4"]],
    "dqn_minatar": [["--game", g] for g in ("breakout", "space_invaders", "freeway", "asterix", "seaquest")]
    + [["--algo", "qrdqn"], ["--dueling", "--eps-decay-steps", "1000", "--stop-reward", "10", "--logdir", "tb"]],
    "highlevel_dqn": [[]],
    "mujoco_a2c": [["--max-epoch", "2"], ["--no-lr-decay", "--seed", "1"]],
    "mujoco_ppo": [["--max-epoch", "1", "--step-per-epoch", "2048"], ["--no-lr-decay"]],
    "mujoco_reinforce": [["--max-epoch", "1", "--step-per-epoch", "4096"], ["--no-lr-decay"]],
    "mujoco_sac": [[], ["--auto-alpha", "--step-per-collect", "1", "--task", "Hopper-v4"]],
    "mujoco_td3": [[], ["--algo", "ddpg", "--pipeline"]],
    "mujoco_trpo": [["--max-epoch", "1", "--optim-critic-iters", "2"], ["--algo", "npg", "--no-lr-decay"]],
    "offline_d4rl_cql": [["{dataset}"], ["{dataset}", "--no-lagrange", "--calibrated", "--normalize-obs",
                                         "--hidden", "64", "64"], ["{dataset}", "--task", "InvertedPendulum-v4"]],
    "ppo_classic": [["--algo", a, "--env", e] for a in ("ppo", "a2c", "pg") for e in ("Pendulum-v1", "CartPole-v1")],
    "sac_pendulum": [["--algo", a] for a in ("sac", "td3", "ddpg")],
}


class Captured(Exception):
    """Raised in place of a trainer's ``run``."""


def _capture_trainers(monkeypatch, *classes) -> dict:
    captured = {}

    def fake_run(self):
        captured["trainer"] = self
        raise Captured

    for cls in classes:
        monkeypatch.setattr(cls, "run", fake_run)
    return captured


def jax_trainer(name, argv, monkeypatch):
    from tianshou_tpu.trainer import offline, offpolicy, onpolicy

    main = jax_main(name)
    captured = _capture_trainers(monkeypatch, offpolicy.OffPolicyTrainer, onpolicy.OnPolicyTrainer,
                                 offline.OfflineTrainer)
    platform = [] if name == "highlevel_dqn" else ["--platform", "cpu"]
    monkeypatch.setattr(sys, "argv", [name, *argv, *platform])
    with pytest.raises(Captured):
        main()
    return captured["trainer"]


def port_trainer(name, argv, monkeypatch):
    """``(trainer, venvs to close)`` of the port module's ``build``."""
    from tianshou_tpu_torch.trainer import offline, offpolicy, onpolicy

    module = port_module(name)
    built, venvs = module.build(module.parser().parse_args([*argv, "--device", "cpu"]))
    if name != "highlevel_dqn":
        return built, venvs
    captured = _capture_trainers(monkeypatch, offpolicy.OffPolicyTrainer, onpolicy.OnPolicyTrainer,
                                 offline.OfflineTrainer)
    with pytest.raises(Captured):
        built.build().run()
    return captured["trainer"], venvs


def _scalars(obj) -> dict:
    return {k: v for k, v in vars(obj).items()
            if not k.startswith("_") and isinstance(v, (bool, int, float, str, type(None)))}


def _assert_scalars_equal(port, ref, what, required=()):
    tp, jp = _scalars(port), _scalars(ref)
    shared = sorted(set(tp) & set(jp))
    assert set(required) <= set(shared), (what, sorted(set(required) - set(shared)))
    got = {k: tp[k] for k in shared}
    want = {k: pytest.approx(jp[k], rel=1e-7) if isinstance(jp[k], float) else jp[k] for k in shared}
    assert got == want, what
    return shared


def _venvs_of(trainer):
    return [c.venv for c in (getattr(trainer, "train_collector", None), trainer.test_collector) if c is not None]


def _obs_example(space, rng, batch=3):
    """Observations in the space's range: pixels in [0, 255] as uint8, 0/1
    grids (MinAtar) as float32, else normals."""
    shape, low, high = tuple(space.shape), np.asarray(space.low), np.asarray(space.high)
    if np.all(high == 255):
        return rng.integers(0, 256, (batch,) + shape).astype(np.uint8)
    if np.all(low == 0) and np.all(high == 1):
        return rng.integers(0, 2, (batch,) + shape).astype(np.float32)
    return rng.normal(size=(batch,) + shape).astype(np.float32)


def _assert_networks_equal(jalgo, talgo, obs_space, act_dim, rng, forward):
    """Each network's Flax parameters, drawn at the shapes ``init`` gives
    (``eval_shape``: Flax's op-by-op ``init`` compiles every new shape,
    seconds a network), load into the port's (strict); with ``forward`` one
    forward is compared (the Flax ``apply`` jitted: one compile)."""
    compared = 0
    for attr in ("network", "actor", "critic"):
        jnet, tnet = getattr(jalgo, attr, None), getattr(talgo, attr, None)
        if jnet is None or tnet is None:
            continue
        inputs = [_obs_example(obs_space, rng)]
        if "Critic" in type(tnet).__name__:
            inputs.append(rng.uniform(-1, 1, (3, act_dim)).astype(np.float32))
        compared += 1
        shapes = jax.eval_shape(jnet.init, jax.random.key(0), *inputs)
        params = jax.tree.map(lambda s: (rng.normal(size=s.shape) * 0.1).astype(s.dtype), shapes)
        load_flax_params(tnet, params)
        if not forward:
            continue
        with torch.no_grad():
            got = jax.tree.leaves(jax.tree.map(lambda t: t.float().numpy(), (tnet(*map(torch.as_tensor, inputs)),)))
        want = jax.tree.leaves((jax.jit(jnet.apply)(params, *inputs),))
        assert len(got) == len(want) > 0, attr
        for g, w in zip(got, want):
            w = np.asarray(w, np.float32)
            if getattr(tnet, "input_dtype", None) == torch.bfloat16:
                np.testing.assert_allclose(g, w, rtol=0, atol=2e-2 * np.abs(w).max(), err_msg=attr)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=attr)
    assert compared, (type(jalgo).__name__, type(talgo).__name__)


def _port_optimizer_path(talgo, p0, grads):
    """The port algorithm's optimizer stepped on ``grads`` from ``p0``, as
    its updates step it: the on-policy family sets a scheduled learning
    rate for update ``k`` before each step (``PG._apply_gradients``)."""
    param = torch.nn.Parameter(torch.tensor(p0))
    if hasattr(talgo, "_optimizer"):
        opt = talgo._optimizer([param], talgo.lr)
    elif talgo.make_optimizer is not None:
        opt = talgo.make_optimizer([param])
    else:
        opt = adam([param], talgo.lr)
    for k, g in enumerate(grads):
        param.grad = torch.tensor(g)
        if callable(talgo.lr):
            for group in opt.param_groups:
                group["lr"] = talgo.lr(k)
        opt.step()
    return param.detach().numpy()


def _assert_optimizers_equal(jalgo, talgo, rng):
    tx = getattr(jalgo, "optimizer", None)
    if not isinstance(tx, optax.GradientTransformation):
        return False
    p0 = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    grads = [(rng.normal(size=8) * 1e-3).astype(np.float32) for _ in range(5)]
    p, state = jax.numpy.asarray(p0), tx.init(jax.numpy.asarray(p0))
    for g in grads:
        updates, state = tx.update(jax.numpy.asarray(g), state, p)
        p = optax.apply_updates(p, updates)
    np.testing.assert_allclose(_port_optimizer_path(talgo, p0, grads), np.asarray(p), rtol=0, atol=5e-7)
    return True


def _assert_same_wiring(jt, tt, forward):
    _assert_scalars_equal(tt, jt, "trainer", required=("max_epoch", "batch_size", "episode_per_test", "seed"))
    assert type(tt).__name__ == type(jt).__name__
    assert type(tt.logger).__name__ == type(jt.logger).__name__
    if hasattr(jt, "train_param_fn"):
        for epoch, step in PARAM_POINTS:
            assert tt.train_param_fn(epoch, step) == pytest.approx(jt.train_param_fn(epoch, step), rel=1e-12)
    assert (tt.stop_fn is None) == (jt.stop_fn is None)
    if jt.stop_fn is not None:
        assert [bool(tt.stop_fn(r)) for r in STOP_POINTS] == [bool(jt.stop_fn(r)) for r in STOP_POINTS]
    if getattr(jt, "buffer", None) is not None:
        assert type(tt.buffer).__name__ == type(jt.buffer).__name__
        for name in ("capacity", "num_envs", "stack_num", "save_only_last_obs", "ignore_obs_next"):
            assert getattr(tt.buffer, name) == getattr(jt.buffer, name), name
    jvenvs, tvenvs = _venvs_of(jt), _venvs_of(tt)
    assert [(type(v).__name__, v.num_envs) for v in tvenvs] == [(type(v).__name__, v.num_envs) for v in jvenvs]
    for tv, jv in zip(tvenvs, jvenvs):
        if hasattr(jv, "update_rms"):
            assert tv.update_rms == jv.update_rms
    jalgo, talgo = jt.algo, tt.algo
    assert type(talgo).__name__ == type(jalgo).__name__
    assert _assert_scalars_equal(talgo, jalgo, "algorithm")
    rng = np.random.default_rng(0)
    _assert_optimizers_equal(jalgo, talgo, rng)
    act_space = talgo.action_space
    act_dim = act_space.shape[0] if getattr(act_space, "shape", None) else 0
    _assert_networks_equal(jalgo, talgo, tvenvs[-1].observation_space, act_dim, rng, forward)


def _close(venvs):
    for venv in venvs:
        if hasattr(venv, "close"):
            venv.close()


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A small D4RL-schema ``.npz`` (Pendulum's widths), for the offline
    script."""
    path = tmp_path_factory.mktemp("d4rl") / "demo.npz"
    rng = np.random.default_rng(0)
    n = 400
    np.savez(path, observations=rng.normal(size=(n, 3)).astype(np.float32),
             actions=rng.uniform(-1, 1, (n, 1)).astype(np.float32), rewards=rng.normal(size=n).astype(np.float32),
             terminals=np.zeros(n, bool), timeouts=np.arange(n) % 200 == 199,
             next_observations=rng.normal(size=(n, 3)).astype(np.float32))
    return str(path)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_build_wires_what_the_jax_script_wires(name, dataset, tmp_path, monkeypatch):
    """Every flag set of ``VARIANTS``; one forward of each network at the
    first (the defaults), the parameter shapes at the others."""
    for i, argv in enumerate(VARIANTS[name]):
        monkeypatch.chdir(tmp_path)  # the scripts' default log directories
        argv = [a.format(dataset=dataset) for a in argv]
        jt = jax_trainer(name, argv, monkeypatch)
        try:
            tt, venvs = port_trainer(name, argv, monkeypatch)
            try:
                _assert_same_wiring(jt, tt, forward=i == 0)
            finally:
                _close(venvs)
        finally:
            _close(_venvs_of(jt))
        monkeypatch.undo()
