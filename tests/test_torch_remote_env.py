"""Remote env farms of the port (tianshou_tpu_torch/envs/remote.py) against
the JAX package's, on the CPU over 127.0.0.1.

- The wire protocol is the JAX package's: a port client drives a JAX farm
  (``python -m tianshou_tpu.envs.remote``) and a JAX client drives a port
  farm (``python -m tianshou_tpu_torch.envs.remote --port 0``, which
  reports the port it bound); reset and steps give observations bitwise
  equal to local envs of the same seeds, uint8 and dict observations in
  their own dtypes.
- Crash recovery: an env that raises inside the farm rebuilds the fleet and
  the client's retried request lands on it; a farm process killed and
  restarted on the same port is reconnected to transparently.
- ``FarmMismatchError`` for another protocol version and for a farm that
  comes back with another fleet.
- ``RemoteEnvFactory`` and a short trainer run through the host path.

Every farm is bounded: sockets have timeouts, subprocesses are killed in a
``finally`` and waited for with a timeout.
"""

import contextlib
import json
import os
import select
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

gym = pytest.importorskip("gymnasium")

from tianshou_tpu.envs.remote import RemoteVectorEnv as JaxRemoteVectorEnv  # noqa: E402
from tianshou_tpu_torch.envs.host import HostVectorEnv  # noqa: E402
from tianshou_tpu_torch.envs.remote import FarmMismatchError, RemoteVectorEnv, serve_envs  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
DEADLINE_S = 60.0


class Uint8DictEnv:
    """Dict observations: uint8 pixels and a float vector, both counting
    steps; episodes of 5 steps; reward = the action."""

    def __init__(self):
        self.observation_space = gym.spaces.Dict({"pix": gym.spaces.Box(0, 255, (4, 4), np.uint8),
                                                  "vec": gym.spaces.Box(-10, 10, (3,), np.float32)})
        self.action_space = gym.spaces.Discrete(3)
        self.t = 0

    def _obs(self):
        return {"pix": np.full((4, 4), self.t % 256, np.uint8), "vec": np.full((3,), float(self.t), np.float32)}

    def reset(self, seed=None, options=None):
        self.t = 0
        return self._obs(), {}

    def step(self, act):
        self.t += 1
        return self._obs(), float(act), self.t >= 5, False, {}

    def close(self):
        pass


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join([TESTS, REPO, env.get("PYTHONPATH", "")])
    return env


@contextlib.contextmanager
def _farm_process(package: str, env_id: str, num_envs: int, port: int = 0):
    """A farm subprocess of ``package``; yields ``(process, port)``.  A port
    farm reports the port it bound; a JAX farm is given a free one."""
    if package == "tianshou_tpu":
        port = port or _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{package}.envs.remote", "--env", env_id, "--num-envs", str(num_envs),
         "--port", str(port), "--host", "127.0.0.1"],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        if package == "tianshou_tpu_torch":
            deadline = time.monotonic() + DEADLINE_S
            line = ""
            while "serving" not in line:
                ready, _, _ = select.select([proc.stdout], [], [], max(0.0, deadline - time.monotonic()))
                if not ready:
                    raise TimeoutError("the farm did not report its port")
                line = proc.stdout.readline()
                if not line:
                    raise RuntimeError(f"the farm exited: {proc.wait(timeout=10)}")
            port = int(line.rsplit(":", 1)[1])
        yield proc, port
    finally:
        proc.kill()
        proc.wait(timeout=30)
        proc.stdout.close()


def _connect(cls, addresses, **kw):
    """Connect, retrying while the farm starts (bounded)."""
    deadline = time.monotonic() + DEADLINE_S
    while True:
        try:
            return cls(addresses, **kw)
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.2)


@contextlib.contextmanager
def _farm_thread(env_fns):
    """A port farm in a thread on a free port; stopped at exit."""
    ports, stop = [], threading.Event()
    th = threading.Thread(target=serve_envs, args=(env_fns,),
                          kwargs=dict(host="127.0.0.1", on_bound=ports.append, stop=stop), daemon=True)
    th.start()
    deadline = time.monotonic() + DEADLINE_S
    while not ports:
        if time.monotonic() > deadline or not th.is_alive():
            raise TimeoutError("the farm thread did not bind")
        time.sleep(0.01)
    try:
        yield f"127.0.0.1:{ports[0]}"
    finally:
        stop.set()
        th.join(timeout=10)
        assert not th.is_alive()


def _cartpole():
    return gym.make("CartPole-v1")


def _assert_like_local(venv, seed=5, steps=60):
    """Reset and steps through ``venv`` equal local CartPole envs, bitwise."""
    local = HostVectorEnv([_cartpole] * venv.num_envs)
    np.testing.assert_array_equal(venv.reset(seed=seed), local.reset(seed=seed))
    rng = np.random.default_rng(0)
    for _ in range(steps):
        acts = rng.integers(0, 2, venv.num_envs)
        res, carry = venv.step(acts)
        lres, lcarry = local.step(acts)
        assert res.obs.dtype == np.float32
        for name in ("obs", "reward", "terminated", "truncated"):
            np.testing.assert_array_equal(getattr(res, name), getattr(lres, name), err_msg=name)
        np.testing.assert_array_equal(carry, lcarry)
    local.close()


def test_port_client_drives_a_jax_farm():
    with _farm_process("tianshou_tpu", "CartPole-v1", 3) as (_, port):
        venv = _connect(RemoteVectorEnv, [f"127.0.0.1:{port}"])
        assert venv.num_envs == 3 and venv.action_space.n == 2
        _assert_like_local(venv)
        venv.close()
    with _farm_process("tianshou_tpu", "test_torch_remote_env:Uint8DictEnv", 2) as (_, port):
        venv = _connect(RemoteVectorEnv, [f"127.0.0.1:{port}"])
        obs = venv.reset(seed=0)
        assert obs["pix"].dtype == np.uint8 and obs["pix"].shape == (2, 4, 4) and obs["vec"].dtype == np.float32
        for t in range(1, 7):
            res, carry = venv.step(np.array([1, 2]))
            te = t if t <= 5 else 1
            np.testing.assert_array_equal(res.obs["pix"], te)
            np.testing.assert_array_equal(res.reward, [1.0, 2.0])
            assert bool(res.terminated.all()) == (te == 5)
        venv.close()


def test_jax_client_drives_a_port_farm():
    with _farm_process("tianshou_tpu_torch", "CartPole-v1", 4) as (_, port):
        venv = _connect(JaxRemoteVectorEnv, [f"127.0.0.1:{port}"])
        assert venv.num_envs == 4
        _assert_like_local(venv, seed=11)
        venv.close()
        # the farm serves the next learner, here the port's own client
        venv = _connect(RemoteVectorEnv, [f"127.0.0.1:{port}"])
        _assert_like_local(venv, seed=2, steps=10)
        venv.close()


def test_uint8_dict_obs_and_two_farms():
    with _farm_thread([Uint8DictEnv] * 3) as a, _farm_thread([Uint8DictEnv] * 2) as b:
        venv = _connect(RemoteVectorEnv, [a, b])
        assert venv.num_envs == 5 and isinstance(venv.observation_space, dict)
        obs = venv.reset(seed=0)
        assert obs["pix"].dtype == np.uint8 and obs["pix"].shape == (5, 4, 4)
        res, carry = venv.step(np.array([0, 1, 2, 0, 1]))
        np.testing.assert_array_equal(res.obs["pix"], 1)
        np.testing.assert_array_equal(res.reward, [0.0, 1.0, 2.0, 0.0, 1.0])
        venv.close()


class _CrashOnceEnv:
    """Raises once, on the first action 1 (class flag)."""

    crashed = False

    def __init__(self):
        self.observation_space = gym.spaces.Box(-1, 1, (2,), np.float32)
        self.action_space = gym.spaces.Discrete(2)
        self.t = 0

    def reset(self, seed=None, options=None):
        self.t = 0
        return np.zeros(2, np.float32), {}

    def step(self, act):
        if int(act) == 1 and not _CrashOnceEnv.crashed:
            _CrashOnceEnv.crashed = True
            raise RuntimeError("simulated env crash")
        self.t += 1
        return np.full(2, self.t, np.float32), 1.0, False, self.t >= 50, {}

    def close(self):
        pass


def test_env_crash_rebuilds_the_fleet():
    _CrashOnceEnv.crashed = False
    with _farm_thread([_CrashOnceEnv] * 2) as addr:
        venv = _connect(RemoteVectorEnv, [addr])
        venv.reset(seed=0)
        res, _ = venv.step(np.zeros(2, np.int64))
        np.testing.assert_array_equal(res.obs, 1.0)
        # env 0 raises in the farm; the re-sent step lands on the rebuilt fleet
        res, _ = venv.step(np.array([1, 0]))
        np.testing.assert_array_equal(res.obs, 1.0)
        res, _ = venv.step(np.zeros(2, np.int64))
        np.testing.assert_array_equal(res.obs, 2.0)
        venv.close()


def test_farm_restart_and_mismatch():
    with _farm_process("tianshou_tpu_torch", "CartPole-v1", 4) as (proc, port):
        venv = _connect(RemoteVectorEnv, [f"127.0.0.1:{port}"], reconnect_timeout=DEADLINE_S)
        venv.reset(seed=0)
        proc.kill()
        proc.wait(timeout=30)
        # a farm restarted on the same port: the next step reconnects
        with _farm_process("tianshou_tpu_torch", "CartPole-v1", 4, port=port):
            res, carry = venv.step(np.ones(4, np.int64))
            assert res.obs.shape == (4, 4) and carry.shape == (4, 4)
        # a farm that comes back with another fleet cannot serve this client
        with _farm_process("tianshou_tpu_torch", "CartPole-v1", 3, port=port):
            with pytest.raises(FarmMismatchError, match="changed shape"):
                venv.step(np.ones(4, np.int64))
        venv.close()


def test_protocol_version_mismatch():
    srv = socket.create_server(("127.0.0.1", 0))
    srv.settimeout(DEADLINE_S)

    def serve_once():
        conn, _ = srv.accept()
        with conn:
            hello = json.dumps({"proto": 99}).encode()
            conn.sendall(struct.pack("<I", len(hello)) + hello)

    th = threading.Thread(target=serve_once, daemon=True)
    th.start()
    try:
        with pytest.raises(FarmMismatchError, match="protocol 99"):
            RemoteVectorEnv([f"127.0.0.1:{srv.getsockname()[1]}"])
    finally:
        th.join(timeout=10)
        srv.close()


def test_remote_env_factory_and_a_trainer_run():
    from tianshou_tpu_torch.algos.dqn import DQN
    from tianshou_tpu_torch.collect.host_collector import HostCollector
    from tianshou_tpu_torch.data.buffer import ReplayBuffer
    from tianshou_tpu_torch.highlevel.env import RemoteEnvFactory
    from tianshou_tpu_torch.networks.common import QNet
    from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer

    with _farm_thread([_cartpole] * 4) as train_addr, _farm_thread([_cartpole] * 2) as test_addr:
        with pytest.raises(ValueError, match="host 4 envs"):
            RemoteEnvFactory([train_addr], [test_addr]).create_envs(5, 2, device="cpu")
        envs = RemoteEnvFactory([train_addr], [test_addr]).create_envs(4, 2, device="cpu")
        assert (envs.train_venv.num_envs, envs.test_venv.num_envs, envs.backend) == (4, 2, "host")
        algo = DQN(QNet(4, (16,), 2), envs.action_space, device="cpu")
        buf = ReplayBuffer(64, 4)
        trainer = OffPolicyTrainer(
            algo, HostCollector(algo, envs.train_venv, buf, device="cpu"),
            HostCollector(algo, envs.test_venv, device="cpu"), buf, max_epoch=1, step_per_epoch=32,
            step_per_collect=16, update_per_step=0.25, batch_size=8, episode_per_test=2, warmup_steps=16,
            train_param_fn=lambda e, s: 0.1, device="cpu")
        info = trainer.run()
        assert (info.env_step, info.gradient_step) == (16 + 32, 8) and np.isfinite(info.best_reward)
        envs.train_venv.close()
        envs.test_venv.close()
