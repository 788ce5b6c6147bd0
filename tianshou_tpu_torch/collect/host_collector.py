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

Every env step acts through an :class:`ActingStep` (the JAX package's
jitted ``_act_fn``): ``act_with_extras`` and ``map_action`` over a static
observation batch, which the step's one host-to-device copy writes from a
pinned host buffer; the raw actions and extras land in row ``t`` of a
preallocated ``[T, N]`` segment, the env action in a static tensor whose
copy back is the step's one synchronisation.  On CUDA the step is a CUDA
graph (:func:`~tianshou_tpu_torch.utils.graphs.compile_step`), captured at
its first call and replayed at every later one; a collector on the CPU
runs it eagerly.  A returned segment's ``act`` and ``policy`` are copied
once out of the static segment: two segments' trajectories never alias.
Two kinds of acting stay eager: ``random=True`` draws on the host with
numpy, and ``act_on_host=True`` acts on the CPU.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Any

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
from tianshou_tpu_torch.utils.graphs import CapturedStep, compile_step, named_tensors, write_row
from tianshou_tpu_torch.utils.transfer import TreePacker

__all__ = ["ActingIO", "ActingStep", "HostCollector"]


@dataclasses.dataclass
class ActingIO:
    """The static inputs and outputs of an acting step (its compiled step's
    collect state): the host writes ``obs`` (and ``mask``) before a step and
    reads ``env_act`` after it."""

    obs: Any  # [N, ...] tensor, or a Batch of them for dict observations
    act: torch.Tensor | None = None  # the raw action [N, ...]
    env_act: torch.Tensor | None = None  # map_action of it
    segment: Batch | None = None  # [T, N, ...] raw actions and extras of a segment
    cursor: torch.Tensor | None = None  # 0-d int64: the segment's next row
    policy_state: Any = ()  # a recurrent policy's per-env carry
    mask: torch.Tensor | None = None  # [N] bool: the rows whose carry advances


def _schema(obs) -> tuple:
    if isinstance(obs, dict):
        return tuple((k, *_schema(v)) for k, v in sorted(obs.items()))
    obs = np.asarray(obs)
    return obs.shape, obs.dtype.str


class _HostInput:
    """A static device tensor and the host buffer (pinned on CUDA) that a
    step's observation or mask crosses from: :meth:`write` copies ``x``
    into the host buffer, then the host buffer to the tensor in one
    asynchronous copy.  The step's synchronisation (the action's copy back)
    ends that copy before the host writes the buffer again."""

    def __init__(self, example: np.ndarray, device: torch.device):
        example = np.asarray(example)
        pinned = device.type == "cuda"
        self.host = torch.empty(example.shape, dtype=torch.from_numpy(example[:0]).dtype, pin_memory=pinned)
        self.view = self.host.numpy()
        self.device = self.host.to(device) if pinned else self.host.clone()

    def write(self, x) -> None:
        np.copyto(self.view, x)
        self.device.copy_(self.host, non_blocking=True)


class ActingStep:
    """The acting step of the host collectors, the fused cycle's first action
    and ``collect_dataset_episodes``: ``act_with_extras`` (or, with a
    recurrent carry, ``act_with_state``) and ``map_action`` over a static
    :class:`ActingIO`, compiled with
    :func:`~tianshou_tpu_torch.utils.graphs.compile_step` (on CUDA a CUDA
    graph captured at its first call; on the CPU run eagerly).

    :meth:`begin` readies it for a run of steps through ``ts``'s acting
    module (:meth:`Algorithm.act_params`), drawing from ``generator``; each
    call then takes the host observations (and, with a carry, the host mask
    of the rows being dispatched) and returns the env action as numpy.
    With ``num_steps`` the raw actions and the policy's extras are written
    into row ``t`` of a ``[num_steps, N]`` segment, which :meth:`segment`
    copies out.

    A compiled step is kept for each ``(explore, num_steps, generator,
    observation schema, carry)``, all over one acting module, identified by
    its tensors (the pipelined host loop acts through a fresh shallow
    ``with_act_params`` every segment, over the same snapshot module): a
    call through another module drops them all and captures again.  A graph
    is never replayed over a state it was not captured over.  The first
    call of each compiled step allocates its outputs (eagerly: the capture's
    warm-up on CUDA)."""

    def __init__(self, algo, device: torch.device):
        self.algo = algo
        self.device = device
        self._steps: dict[tuple, tuple] = {}
        self._module: torch.nn.Module | None = None
        self._tensors: list[torch.Tensor] | None = None
        self._ts = None
        self._current: tuple | None = None

    def _build(self, explore: bool, num_steps: int, io: ActingIO):
        algo = self.algo

        def step(module, io: ActingIO, bstate, generator, explore_param):
            ts = self._ts if module is None else algo.with_act_params(self._ts, module)
            if io.mask is None:
                act, extras = algo.act_with_extras(ts, io.obs, generator, explore, explore_param)
            else:
                act, extras, new_state = algo.act_with_state(ts, io.obs, io.policy_state, generator, explore,
                                                             explore_param)
                # the carries advance for the dispatched rows only
                for old, new in zip(tree_leaves(io.policy_state), tree_leaves(new_state)):
                    old.copy_(torch.where(io.mask.view((-1,) + (1,) * (old.dim() - 1)), new, old))
            env_act = algo.map_action(act)
            rows = Batch(act=act, policy=extras)
            if io.act is None:  # the first call: the outputs take the step's shapes
                io.act, io.env_act = torch.empty_like(act), torch.empty_like(env_act)
                if io.cursor is not None:
                    io.segment = tree_map(lambda x: x.new_empty((num_steps,) + x.shape), rows)
            io.act.copy_(act)
            io.env_act.copy_(env_act)
            if io.cursor is not None:
                for out, row in zip(tree_leaves(io.segment), tree_leaves(rows)):
                    write_row(out, io.cursor, row)
                io.cursor.add_(1)
            return module, io, bstate, None, None

        return compile_step(step, self.device, self._module, io, None, prepare_optimizers=False,
                            name="collect.acting")

    def begin(self, ts, obs, generator: torch.Generator, explore: bool, explore_param: float = 0.0,
              num_steps: int = 0, policy_state: Any = ()) -> ActingStep:
        """Ready the step for calls through ``ts``'s acting module on
        observations shaped as ``obs``; with ``num_steps``, the segment's
        row cursor is reset (one fill).  ``policy_state`` is a recurrent
        carry (static: advanced in place).  Returns ``self``."""
        # no train state (a policy without parameters, injected actions): no module
        module = None if ts is None else self.algo.act_params(ts)
        tensors = [t for _, t in named_tensors(module)]
        if self._tensors is None or len(tensors) != len(self._tensors) or any(
                a is not b for a, b in zip(tensors, self._tensors)):
            self._steps.clear()
            self._module, self._tensors = module, tensors
        carry = tree_leaves(policy_state)
        key = (explore, num_steps, id(generator), _schema(obs), tuple(id(t) for t in carry))
        if key not in self._steps:
            inputs = ({k: _HostInput(v, self.device) for k, v in obs.items()} if isinstance(obs, dict)
                      else _HostInput(obs, self.device))
            static_obs = (Batch({k: v.device for k, v in inputs.items()}) if isinstance(inputs, dict)
                          else inputs.device)
            mask = _HostInput(np.zeros(len(tree_leaves(static_obs)[0]), bool), self.device) if carry else None
            io = ActingIO(obs=static_obs, policy_state=policy_state, mask=None if mask is None else mask.device,
                          cursor=torch.zeros((), dtype=torch.int64, device=self.device) if num_steps else None)
            self._steps[key] = (self._build(explore, num_steps, io), io, inputs, mask, generator)
        self._ts, self._current = ts, self._steps[key]
        compiled, io = self._current[:2]
        if isinstance(compiled, CapturedStep):
            compiled.explore.fill_(float(explore_param))
            self._explore = compiled.explore
        else:
            self._explore = explore_param
        if io.cursor is not None:
            io.cursor.zero_()
        return self

    def __call__(self, obs, mask: np.ndarray | None = None) -> np.ndarray:
        """One step on the host observations ``obs`` (with a carry, ``mask``
        marks the rows being dispatched): the env action, copied back."""
        compiled, io, inputs, mask_input, generator = self._current
        if isinstance(inputs, dict):
            for k, v in inputs.items():
                v.write(obs[k])
        else:
            inputs.write(obs)
        if mask_input is not None:
            mask_input.write(mask)
        compiled(self._module, io, None, generator, self._explore)
        # the step's one synchronisation; a copy of the caller's own, on the
        # CPU too, where the next step writes the static tensor again
        return io.env_act.to("cpu", copy=True).numpy()

    @property
    def io(self) -> ActingIO:
        return self._current[1]

    @property
    def compiled(self):
        """The current compiled step (a ``CapturedStep`` on CUDA)."""
        return self._current[0]

    def segment(self) -> tuple[torch.Tensor, Batch | None]:
        """The segment's raw actions and extras (None without extras),
        copied out of the static segment: the caller's own."""
        seg = tree_map(torch.clone, self.io.segment)
        return seg["act"], (seg["policy"] if tree_leaves(seg["policy"]) else None)


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
        # the acting step on each device it acts on (the card; the CPU with
        # act_on_host)
        self._acting_steps: dict[torch.device, ActingStep] = {}

    def reset(self, seed: int = 0) -> None:
        self.obs = self.venv.reset(seed)
        self.ep_ret[:] = 0
        self.ep_len[:] = 0

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

    def acting(self, ts: TrainState, generator: torch.Generator, explore: bool, explore_param: float = 0.0,
               num_steps: int = 0, device: torch.device | None = None) -> ActingStep:
        """The collector's :class:`ActingStep` on ``device`` (default: the
        collector's), begun for steps through ``ts`` on the current
        observations."""
        device = device or self.device
        if device not in self._acting_steps:
            self._acting_steps[device] = ActingStep(self.algo, device)
        return self._acting_steps[device].begin(ts, self.obs, generator, explore, explore_param, num_steps)

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
        host_steps, acts, returns, lens = [], [], [], []
        ctx = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
        with ctx:
            acting = None if random else self.acting(ts, generator, explore, explore_param, num_steps, act_device)
            for _ in range(num_steps):
                if random:
                    raw_act, env_act = sample(self.venv.num_envs)
                    acts.append(raw_act)
                else:
                    env_act = acting(self.obs)
                res, carry = self.venv.step(env_act)
                r, l_ = self._track(res)
                returns += r
                lens += l_
                host_steps.append(Batch(obs=self.obs, rew=res.reward, terminated=res.terminated,
                                        truncated=res.truncated, obs_next=res.obs))
                self.obs = carry
            act, policy = (np.stack(acts), None) if random else acting.segment()
            if on_host:
                # host tensors: the segment's packed copy carries them
                act, policy = act.numpy(), tree_map(lambda x: x.numpy(), policy) if policy is not None else None
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
        acting = self.acting(ts, generator, explore, explore_param, device=act_device)
        for _ in range(max_steps):
            res, carry = self.venv.step(acting(self.obs))
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
