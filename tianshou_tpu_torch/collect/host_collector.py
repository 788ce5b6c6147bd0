"""Collector for host-process envs (port of
``tianshou_tpu/collect/host_collector.py``).

Each step acts on the card over the batched observations and copies the
mapped env action back to the host, where a :class:`HostVectorEnv` steps the
envs: that one device-to-host copy a step is inherent, since the env runs on
the host.  A segment's host leaves (``obs, rew, terminated, truncated,
obs_next``) are stacked ``[T, N, ...]`` in numpy; the raw actions and the
policy's extras (``policy``, e.g. PPO's ``log_prob``) stay on the card,
stacked.  Written to a buffer or handed to the on-policy learner, the host
leaves cross to the card as ONE packed copy
(:class:`~tianshou_tpu_torch.utils.transfer.TreePacker`); tensor leaves, at
any depth of the trajectory, stay where they are.

``random=True`` takes uniform actions in ``[-1, 1]`` (a ``Box``; uniform
indices for ``Discrete``) on the host instead of the policy's, mapped by
``map_action``'s affine transform: the reference's random warm-up.

Acting may run on a side CUDA stream (``stream``), for the trainer's
pipelined mode; the segment's actions are then handed to the current
stream.

``act_on_host=True`` acts on the host CPU through a copy of the acting
module (:meth:`Algorithm.act_params`), refreshed from the card once a
segment in one packed device-to-host copy per dtype; the raw actions and
extras are then numpy leaves that join the segment's packed copy.  It is
off by default: the JAX package turns it on for an accelerator behind a
high-latency link, while on a local card each step's act stays on the card.
Acting parameters are then one segment stale within a segment, as in the
JAX package.

A multi-agent env's reward is ``[N, A]``: the episode returns carry that
shape, and ``reward_metric`` scalarises the finished episodes' ``[K, A]``
per-agent returns to ``[K]`` (default: the first agent's column).
"""

from __future__ import annotations

import contextlib
import copy

import numpy as np
import torch

from tianshou_tpu_torch.algos.base import Algorithm, TrainState
from tianshou_tpu_torch.collect.collector import CollectStats, _default_reward_metric
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer import ReplayBuffer, ReplayBufferState
from tianshou_tpu_torch.data.tree import tree_leaves, tree_map
from tianshou_tpu_torch.envs.host import HostVectorEnv
from tianshou_tpu_torch.envs.spaces import Box
from tianshou_tpu_torch.utils.device import make_generator, resolve_device
from tianshou_tpu_torch.utils.transfer import TreePacker

__all__ = ["HostCollector"]


def _split_tensors(tree: dict) -> tuple[dict, dict]:
    """``(host part, tensor part)`` of a dict tree: its numpy leaves and its
    tensor leaves, each in the tree's nesting, empty branches left out."""
    host, dev = type(tree)(), type(tree)()
    for k, v in tree.items():
        if isinstance(v, dict):
            h, d = _split_tensors(v)
            if h:
                host[k] = h
            if d:
                dev[k] = d
        elif isinstance(v, torch.Tensor):
            dev[k] = v
        else:
            host[k] = v
    return host, dev


def _merge(a: dict, b: dict) -> dict:
    """The union of two dict trees with disjoint leaves."""
    out = type(a)(a)
    for k, v in b.items():
        out[k] = _merge(out[k], v) if k in out else v
    return out


class HostCollector:
    is_host_collector = True

    def __init__(
        self,
        algo: Algorithm,
        venv: HostVectorEnv,
        buffer: ReplayBuffer | None = None,
        device: str | torch.device = "cuda",
        reward_metric=None,
        act_on_host: bool = False,
    ):
        self.device = resolve_device(device)
        if algo.device != self.device:
            raise ValueError(f"collector on {self.device}, algorithm on {algo.device}")
        self.algo = algo
        self.venv = venv
        self.buffer = buffer
        self.reward_metric = reward_metric
        self.act_on_host = act_on_host
        self.obs = None
        self.ep_ret = np.zeros(venv.num_envs)
        self.ep_len = np.zeros(venv.num_envs, np.int64)
        self._packers: dict[str, TreePacker] = {}
        # act_on_host: the host copy of the acting module and its stream
        self._host_module: torch.nn.Module | None = None
        self._host_generator: torch.Generator | None = None

    def reset(self, seed: int = 0) -> None:
        self.obs = self.venv.reset(seed)
        self.ep_ret[:] = 0
        self.ep_len[:] = 0

    def _device_obs(self, obs, device: torch.device | None = None):
        device = device or self.device
        if isinstance(obs, dict):
            return Batch({k: torch.as_tensor(v, device=device) for k, v in obs.items()})
        return torch.as_tensor(obs, device=device)

    def _sync_host_actor(self, ts: TrainState) -> TrainState:
        """``ts`` acting through the host copy of its acting module, whose
        values are refreshed from the card now: one device-to-host copy of
        the module's tensors packed per dtype."""
        module = self.algo.act_params(ts)
        if self._host_module is None:
            self._host_module = copy.deepcopy(module).to("cpu").requires_grad_(False)
        src = list(module.state_dict().values())
        dst = list(self._host_module.state_dict().values())
        with torch.no_grad():
            for dtype in dict.fromkeys(t.dtype for t in src):
                pairs = [(a, b) for a, b in zip(src, dst) if a.dtype == dtype]
                flat = torch.cat([a.reshape(-1) for a, _ in pairs]).cpu()
                for (_, b), v in zip(pairs, flat.split([b.numel() for _, b in pairs])):
                    b.copy_(v.view_as(b))
        return self.algo.with_act_params(ts, self._host_module)

    def _acting(self, ts: TrainState, generator: torch.Generator):
        """``(ts, generator, device)`` to act with: unchanged, or with
        ``act_on_host`` the host copy of the actor (synced now) and a CPU
        stream seeded once from ``generator``."""
        if not self.act_on_host:
            return ts, generator, self.device
        if self._host_generator is None:
            seed = int(torch.randint(0, 2**62, (1,), generator=generator, device=generator.device).item())
            self._host_generator = make_generator(seed, torch.device("cpu"))
        return self._sync_host_actor(ts), self._host_generator, torch.device("cpu")

    def _episode_metric(self, ep_rew: np.ndarray) -> np.ndarray:
        """The finished episodes' returns: ``reward_metric`` of per-agent
        returns ``[K, A]``, by default the first agent's column."""
        return np.asarray((self.reward_metric or _default_reward_metric)(ep_rew))

    def _random_sampler(self, generator: torch.Generator):
        """``n -> (raw action, env action)`` drawn on the host from a numpy
        stream seeded by one draw of ``generator``."""
        seed = int(torch.randint(0, 2**62, (1,), generator=generator, device=generator.device).item())
        rng = np.random.default_rng(seed)
        space = self.algo.action_space
        if isinstance(space, Box):
            lo, hi = space.low_arr().numpy(), space.high_arr().numpy()

            def sample(n):
                u = rng.uniform(-1.0, 1.0, (n,) + space.shape).astype(np.float32)
                return u, lo + (u + 1.0) * 0.5 * (hi - lo)
        else:

            def sample(n):
                a = rng.integers(0, space.n, (n,))
                return a, a
        return sample

    def _accumulate_rew(self, rew: np.ndarray) -> None:
        """One step's rewards into the episode carries; a per-agent reward
        ``[N, A]`` widens the return carry to its shape at the first step."""
        rew = np.asarray(rew)
        if rew.shape != self.ep_ret.shape:
            self.ep_ret = np.zeros(rew.shape, self.ep_ret.dtype)
        self.ep_ret += rew
        self.ep_len += 1

    def _track(self, res) -> tuple[list, list]:
        """Episode bookkeeping of one step: the returns and lengths of the
        episodes it ended."""
        done = res.terminated | res.truncated
        self._accumulate_rew(res.reward)
        if not done.any():
            return [], []
        returns, lens = self._episode_metric(self.ep_ret[done]).tolist(), self.ep_len[done].tolist()
        self.ep_ret[done] = 0
        self.ep_len[done] = 0
        return returns, lens

    def collect(
        self,
        ts: TrainState,
        bstate: ReplayBufferState | None,
        num_steps: int,
        generator: torch.Generator,
        explore: bool = True,
        explore_param: float = 0.0,
        record_traj: bool = False,
        random: bool = False,
        stream: torch.cuda.Stream | None = None,
    ) -> tuple[ReplayBufferState | None, CollectStats, Batch | None]:
        """Collect ``num_steps`` steps per env; returns ``(bstate, stats,
        trajectory or None)``.  With a buffer and ``bstate`` the segment is
        written to the buffer."""
        if self.obs is None:
            raise RuntimeError("call reset() first")
        sample = self._random_sampler(generator) if random else None
        on_host = self.act_on_host and not random
        ts, generator, act_device = self._acting(ts, generator) if on_host else (ts, generator, self.device)
        host_steps, acts, extras, returns, lens = [], [], [], [], []
        ctx = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
        with ctx:
            for _ in range(num_steps):
                if random:
                    raw_act, env_act = sample(self.venv.num_envs)
                else:
                    raw_act, step_extras = self.algo.act_with_extras(
                        ts, self._device_obs(self.obs, act_device), generator, explore, explore_param)
                    env_act = self.algo.map_action(raw_act).cpu().numpy()
                    if on_host:
                        # host tensors: the segment's packed copy carries them
                        raw_act, step_extras = raw_act.numpy(), tree_map(lambda x: x.numpy(), step_extras)
                    if step_extras:
                        extras.append(step_extras)
                res, carry = self.venv.step(env_act)
                r, l_ = self._track(res)
                returns += r
                lens += l_
                host_steps.append(Batch(obs=self.obs, rew=res.reward, terminated=res.terminated,
                                        truncated=res.truncated, obs_next=res.obs))
                acts.append(raw_act)
                self.obs = carry
            stack = np.stack if random or on_host else torch.stack
            act = stack(acts)
            policy = tree_map(lambda *xs: stack(xs), *extras) if extras else None
        if stream is not None and not random and not on_host:
            current = torch.cuda.current_stream(self.device)
            current.wait_stream(stream)
            for x in [act, *tree_leaves(policy or {})]:
                x.record_stream(current)
        traj = tree_map(lambda *xs: np.stack(xs), *host_steps)
        traj["act"] = act
        if policy is not None:
            traj["policy"] = policy
        if self.buffer is not None and bstate is not None:
            bstate = self.buffer.add_trajectory(bstate, self.to_device(traj))
        stats = CollectStats(
            n_collected_steps=num_steps * self.venv.num_envs,
            n_collected_episodes=len(returns),
            returns=np.asarray(returns),
            lens=np.asarray(lens, np.int64),
        )
        return bstate, stats, (traj if record_traj else None)

    def _packer(self, host: Batch) -> TreePacker:
        """The packer of a tree of numpy leaves (one per schema)."""
        key = repr(tree_map(lambda x: (np.shape(x), np.asarray(x).dtype.str), host))
        if key not in self._packers:
            self._packers[key] = TreePacker(host, self.device)
        return self._packers[key]

    def upload(self, traj: Batch, staging: tuple | None = None) -> tuple[TreePacker, torch.Tensor, Batch]:
        """``traj``'s numpy leaves packed and sent to the card in ONE copy:
        ``(packer, flat buffer, tensor leaves)`` for :meth:`unpack`.  Tensor
        leaves at any depth (the actions, the policy's extras) are not
        copied.  With ``staging`` (an earlier segment's upload, the static
        input of a CUDA graph of the learning) the segment is written into
        it instead: the packed copy into its flat buffer, the tensor leaves
        into its own (on the device); returns ``staging``."""
        host, dev = _split_tensors(traj)
        packer = self._packer(host)
        if staging is None:
            return packer, packer.to_device(host), dev
        static_packer, flat, static_dev = staging
        src, dst = tree_leaves(dev), tree_leaves(static_dev)
        if packer is not static_packer or [(t.shape, t.dtype) for t in src] != [(t.shape, t.dtype) for t in dst]:
            raise ValueError("the segment's schema differs from the staging's")
        packer.to_device(host, out=flat)
        if dst:
            with torch.no_grad():
                torch._foreach_copy_(dst, src)
        return staging

    @staticmethod
    def unpack(uploaded: tuple[TreePacker, torch.Tensor, Batch]) -> Batch:
        """The segment on the card from :meth:`upload`'s result."""
        packer, flat, dev = uploaded
        return _merge(packer.unpack(flat), dev)

    def to_device(self, traj: Batch) -> Batch:
        """The segment on the card: every numpy leaf through one packed copy,
        tensor leaves as they are."""
        return self.unpack(self.upload(traj))

    def collect_episodes(
        self,
        ts: TrainState,
        generator: torch.Generator,
        n_episode: int,
        explore: bool = False,
        explore_param: float = 0.0,
        max_steps: int = 100_000,
    ) -> CollectStats:
        """Collect exactly ``n_episode`` episodes from envs reset with a seed
        drawn from ``generator``; env ``i`` contributes its first
        ``n // N + (i < n % N)``."""
        n = self.venv.num_envs
        quota = np.full(n, n_episode // n, np.int64)
        quota[: n_episode % n] += 1
        self.reset(seed=int(torch.randint(0, 2**31 - 1, (1,), generator=generator, device=generator.device).item()))
        ts, generator, act_device = self._acting(ts, generator)
        counts = np.zeros(n, np.int64)
        returns, lens = [], []
        for _ in range(max_steps):
            raw_act = self.algo.act(ts, self._device_obs(self.obs, act_device), generator, explore, explore_param)
            res, carry = self.venv.step(self.algo.map_action(raw_act).cpu().numpy())
            done = res.terminated | res.truncated
            self._accumulate_rew(res.reward)
            for i in np.nonzero(done)[0]:
                if counts[i] < quota[i]:
                    returns.append(float(self._episode_metric(self.ep_ret[i:i + 1])[0]))
                    lens.append(int(self.ep_len[i]))
                counts[i] += 1
                self.ep_ret[i] = 0
                self.ep_len[i] = 0
            self.obs = carry
            if np.all(counts >= quota):
                break
        return CollectStats(
            n_collected_steps=int(np.sum(lens)),
            n_collected_episodes=len(returns),
            returns=np.asarray(returns),
            lens=np.asarray(lens, np.int64),
        )
