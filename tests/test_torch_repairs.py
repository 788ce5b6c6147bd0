"""Two repairs of the port against the JAX package, on the CPU.

- ``Collector.collect`` has the reference's signature and result: one
  greedy segment with ``record_traj=True`` over the pixel env (3 envs, 20
  steps, episodes of 7 steps, env phases injected on both sides as in
  ``tests/test_torch_slice.py``) gives the JAX collector's four values:
  the stats and the ``[T, N]`` trajectory bitwise, the buffer state
  bitwise; a positional call written to the reference binds the same way,
  and ``random`` is keyword only.
- ``DQN`` takes an ``optimizer`` factory: two DQN updates with an optax
  override (``optax.sgd`` with momentum against ``torch.optim.SGD``; the
  optax-form ``RMSprop`` against ``optax.rmsprop``) from the same
  parameters and batches within rtol 1e-4 / atol 1e-5, and the DQN family
  (C51, Rainbow, QRDQN, IQN, FQF, BDQ, DRQN, DiscreteCQL) passes it through.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tianshou_tpu.algos.dqn import DQN as JaxDQN
from tianshou_tpu.collect.collector import Collector as JaxCollector
from tianshou_tpu.data.buffer import ReplayBuffer as JaxReplayBuffer
from tianshou_tpu.envs.base import VectorEnv as JaxVectorEnv
from tianshou_tpu.envs.spaces import Discrete as JaxDiscrete
from tianshou_tpu.networks.common import QNet as JaxQNet
from tianshou_tpu.networks.conv import ConvQNet as JaxConvQNet
from tianshou_tpu_torch.algos.dqn import DQN
from tianshou_tpu_torch.collect.collector import Collector
from tianshou_tpu_torch.data.buffer import ReplayBuffer
from tianshou_tpu_torch.envs.base import VectorEnv
from tianshou_tpu_torch.envs.spaces import Discrete
from tianshou_tpu_torch.networks.common import QNet
from tianshou_tpu_torch.networks.conv import ConvQNet
from tianshou_tpu_torch.networks.convert import params_from_flax
from test_torch_distributional import _dqn_sampled
from test_torch_slice import _JaxPixel, _Pixel

H = W = 36
C, A, N_ENVS, CAP, SEG = 2, 4, 3, 16, 20


def _segment_sides():
    enc = ({"compute_dtype": jnp.float32}, {"compute_dtype": torch.float32})
    jenv, tenv = _JaxPixel(H, W, C, num_actions=A, episode_len=7), _Pixel(H, W, C, num_actions=A, episode_len=7)
    kw = dict(lr=1e-3, gamma=0.9, n_step=2)
    jalgo = JaxDQN(JaxConvQNet(A, "nature", enc[0]), jenv.action_space, **kw)
    talgo = DQN(ConvQNet((H, W, C), A, "nature", enc[1]), tenv.action_space, device="cpu", **kw)
    jbuf, tbuf = JaxReplayBuffer(CAP, N_ENVS), ReplayBuffer(CAP, N_ENVS)
    jcol = JaxCollector(jalgo, JaxVectorEnv(jenv, N_ENVS), jbuf)
    tcol = Collector(talgo, VectorEnv(tenv, N_ENVS, device="cpu"), tbuf, device="cpu")
    jcs, tcs = jcol.reset(jax.random.key(0)), tcol.reset(torch.Generator().manual_seed(0))
    # the env phases: a different frame seed and step count per env
    seeds, t0 = np.array([11, 222, 3333], np.int32), np.array([0, 2, 5], np.int32)
    jes = type(jcs.env_state)(jnp.asarray(t0), jnp.asarray(seeds))
    jcs = jcs.replace(env_state=jes, obs=jax.vmap(jenv._frame)(jes.t, jes.seed))
    tes = type(tcs.env_state)(torch.from_numpy(t0), torch.from_numpy(seeds))
    tcs.env_state, tcs.obs = tes, tenv.frame(tes.t, tes.seed)
    jts = jalgo.init(jax.random.key(1), jcs.obs[0])
    tts = talgo.init(torch.Generator().manual_seed(1))
    sd = params_from_flax(jax.device_get(jts.params))
    tts.online.load_state_dict(sd)
    tts.target.load_state_dict(sd)
    jbs = jbuf.init(jcol.example_transition(jts, jcs))
    tbs = tbuf.init(tcol.example_transition(tts, tcs), device="cpu")
    return (jcol, jts, jcs, jbs), (tcol, tts, tcs, tbs)


def test_collect_returns_the_reference_four_values_with_record_traj():
    (jcol, jts, jcs, jbs), (tcol, tts, tcs, tbs) = _segment_sides()
    jcs, jbs, jstats, jtraj = jcol.collect(jts, jcs, jbs, SEG, explore=False, record_traj=True)
    # positional, as code written to the reference calls it
    tcs, tbs, tstats, ttraj = tcol.collect(tts, tcs, tbs, SEG, False, 0.0, True)
    assert jstats.n_collected_episodes > 0
    assert (tstats.n_collected_steps, tstats.n_collected_episodes) == (
        jstats.n_collected_steps, jstats.n_collected_episodes)
    np.testing.assert_array_equal(tstats.returns, np.asarray(jstats.returns))
    np.testing.assert_array_equal(tstats.lens, np.asarray(jstats.lens))
    assert set(ttraj) == set(jtraj)
    for k in jtraj:
        assert tuple(ttraj[k].shape) == np.shape(jtraj[k]) and ttraj[k].shape[:2] == (SEG, N_ENVS), k
        np.testing.assert_array_equal(ttraj[k].numpy(), np.asarray(jtraj[k]), err_msg=k)
    for k in jbs.storage:
        np.testing.assert_array_equal(tbs.storage[k].numpy(), np.asarray(jbs.storage[k]), err_msg=k)
    np.testing.assert_array_equal(tbs.cursor.numpy(), np.asarray(jbs.cursor))
    np.testing.assert_array_equal(tcs.obs.numpy(), np.asarray(jcs.obs))
    # without record_traj the fourth value is None, on both sides
    assert jcol.collect(jts, jcs, jbs, 2)[3] is None and tcol.collect(tts, tcs, tbs, 2)[3] is None


def test_collect_takes_random_by_keyword_only():
    params = inspect.signature(Collector.collect).parameters
    assert list(params)[:8] == ["self", "ts", "cstate", "bstate", "num_steps", "explore", "explore_param",
                                "record_traj"]
    assert params["random"].kind is inspect.Parameter.KEYWORD_ONLY
    (_, _, _, _), (tcol, tts, tcs, tbs) = _segment_sides()
    _, tbs, stats, traj = tcol.collect(tts, tcs, tbs, 4, random=True)
    assert traj is None and stats.n_collected_steps == 4 * N_ENVS and int(tbs.size.min()) == 4


OPTIMIZERS = {
    "sgd-momentum": (lambda: optax.sgd(0.05, momentum=0.9),
                     lambda params: torch.optim.SGD(params, lr=0.05, momentum=0.9)),
    "rmsprop": (lambda: optax.rmsprop(1e-2), None),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_dqn_optimizer_override_matches_optax(name):
    from tianshou_tpu_torch.algos.qrdqn import RMSprop

    jopt, topt = OPTIMIZERS[name]
    topt = topt or (lambda params: RMSprop(params, 1e-2))
    obs, hid, acts = 4, (32, 32), 3
    jalgo = JaxDQN(JaxQNet(hid, acts), JaxDiscrete(acts), optimizer=jopt(), gamma=0.9, n_step=2,
                   target_update_freq=2)
    talgo = DQN(QNet(obs, hid, acts), Discrete(acts), optimizer=topt, gamma=0.9, n_step=2, target_update_freq=2,
                device="cpu")
    jts = jalgo.init(jax.random.key(0), jnp.zeros((obs,), jnp.float32))
    tts = talgo.init(torch.Generator().manual_seed(0))
    assert type(tts.optimizer) is (torch.optim.SGD if name == "sgd-momentum" else RMSprop)
    sd = params_from_flax(jax.device_get(jts.params))
    tts.online.load_state_dict(sd)
    tts.target.load_state_dict(sd)
    jbuf = JaxReplayBuffer(8, 2)
    update = jax.jit(lambda ts, s, k: jalgo.update_sampled(ts, jbuf, None, s, k))
    for step in (1, 2):
        js, ts_ = _dqn_sampled(step)
        jts, _, jm = update(jts, js, jax.random.key(step))
        tts, _, tm = talgo.update_sampled(tts, None, None, ts_)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-5, err_msg=f"{name} {k}")
        for module, flax_params in ((tts.online, jts.params), (tts.target, jts.target_params)):
            ref = params_from_flax(jax.device_get(flax_params))
            for key, val in module.state_dict().items():
                np.testing.assert_allclose(val.numpy(), ref[key].numpy(), rtol=1e-4, atol=1e-5,
                                           err_msg=f"{name} step {step} {key}")
    moved = params_from_flax(jax.device_get(jts.params))
    assert any(not torch.equal(moved[k], v) for k, v in sd.items())


def _family():
    from tianshou_tpu_torch.algos.bdq import BDQ
    from tianshou_tpu_torch.algos.c51 import C51, Rainbow
    from tianshou_tpu_torch.algos.drqn import DRQN
    from tianshou_tpu_torch.algos.offline import DiscreteCQL
    from tianshou_tpu_torch.algos.qrdqn import FQF, IQN, QRDQN
    from tianshou_tpu_torch.envs.spaces import MultiDiscrete
    from tianshou_tpu_torch.networks.common import BranchingQNet, RecurrentQNet
    from tianshou_tpu_torch.networks.discrete import (
        C51Net,
        FractionProposalNetwork,
        FullQuantileFunction,
        ImplicitQuantileNetwork,
        QRDQNNet,
    )

    d = Discrete(2)
    return {
        "C51": lambda **kw: C51(C51Net(4, (8,), 2, num_atoms=5), d, num_atoms=5, **kw),
        "Rainbow": lambda **kw: Rainbow(C51Net(4, (8,), 2, num_atoms=5, noisy=True), d, num_atoms=5, **kw),
        "QRDQN": lambda **kw: QRDQN(QRDQNNet(4, (8,), 2, 4), d, num_quantiles=4, **kw),
        "IQN": lambda **kw: IQN(ImplicitQuantileNetwork(4, (8,), 2), d, **kw),
        "FQF": lambda **kw: FQF(FullQuantileFunction(4, (8,), 2), FractionProposalNetwork(8, 4), d, num_fractions=4,
                                **kw),
        "BDQ": lambda **kw: BDQ(BranchingQNet(4, (8,), 2, 3), MultiDiscrete((3, 3)), **kw),
        "DRQN": lambda **kw: DRQN(RecurrentQNet(4, 8, 2), d, **kw),
        "DiscreteCQL": lambda **kw: DiscreteCQL(QRDQNNet(4, (8,), 2, 4), d, num_quantiles=4, **kw),
    }


@pytest.mark.parametrize("name", ["C51", "Rainbow", "QRDQN", "IQN", "FQF", "BDQ", "DRQN", "DiscreteCQL"])
def test_dqn_family_passes_the_optimizer_through(name):
    made = []

    def factory(params):
        made.append(len(params))
        return torch.optim.SGD(params, lr=0.1)

    algo = _family()[name](optimizer=factory, device="cpu")
    ts = algo.init(torch.Generator().manual_seed(0))
    assert type(ts.optimizer) is torch.optim.SGD and made == [len(list(ts.online.parameters()))]
    default = _family()[name](lr=3e-4, device="cpu").init(torch.Generator().manual_seed(0))
    assert type(default.optimizer) is torch.optim.Adam and default.optimizer.defaults["lr"] == 3e-4
