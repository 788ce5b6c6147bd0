"""Device-resident ring replay buffer (port of ``tianshou_tpu/data/buffer.py``).

Storage leaves are ``[num_envs, capacity, ...]`` tensors on the buffer's
device, with ``[num_envs]`` int64 cursors (next write slot) and sizes
(valid entries).  Index semantics are the JAX package's, which mirror the
reference's:
- per-env circular writes;
- episode-aware ``next``: saturates at an episode end or at the newest entry;
- episode-aware ``prev``: saturates at an episode start or the oldest entry,
  which is what frame stacks are rebuilt from.

Ring arithmetic uses ``torch.remainder`` (Python-style ``%``; ``fmod`` would
keep the sign of a negative position).  Unlike the JAX package, whose state
is immutable, the writes (:meth:`ReplayBuffer.add`, :meth:`add_masked`,
:meth:`merge`) change the storage in place: a copy of a pixel ring per step
would cost as much memory as the ring itself.

The memory options are the reference's: ``stack_num`` rebuilds frame stacks
at sample time, ``save_only_last_obs`` stores one frame per slot,
``ignore_obs_next`` stores no ``obs_next`` and ``sample_avail`` samples only
slots with a whole in-episode stack.  A uint8 leaf asked for in bfloat16 is
gathered by :func:`gather_rows_cast`, a whole ``[B, stack_num]`` stack in one
launch.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.tree import tree_leaves, tree_map
from tianshou_tpu_torch.ops.gather import gather_rows_cast
from tianshou_tpu_torch.utils.device import resolve_device

__all__ = ["ReplayBuffer", "ReplayBufferState"]


@dataclasses.dataclass
class ReplayBufferState:
    storage: Batch
    cursor: torch.Tensor  # [num_envs] int64
    size: torch.Tensor  # [num_envs] int64


def _write(buf: Any, val: Any, env_ids: torch.Tensor, cursor: torch.Tensor, mask: torch.Tensor | None) -> None:
    if isinstance(buf, dict):
        for k, b in buf.items():
            _write(b, val[k], env_ids, cursor, mask)
    elif mask is None:
        buf[env_ids, cursor] = val
    else:
        m = mask.reshape(mask.shape + (1,) * (buf.dim() - 2))
        buf[env_ids, cursor] = torch.where(m, val, buf[env_ids, cursor])


class ReplayBuffer:
    """Static configuration + ops over :class:`ReplayBufferState`.

    Storage keys: ``obs, act, rew, terminated, truncated, obs_next`` plus any
    extras; ``done`` is derived, not stored.
    """

    def __init__(
        self,
        capacity: int,
        num_envs: int = 1,
        stack_num: int = 1,
        save_only_last_obs: bool = False,
        ignore_obs_next: bool = False,
        sample_avail: bool = False,
    ):
        """Memory options (reference ``buffer/base.py:55-77``):

        - ``save_only_last_obs``: the env emits frame-stacked observations
          ``[stack, ...]``; only the newest frame of each is stored, and
          stacks are rebuilt at sample time from the ``prev`` chain.
        - ``ignore_obs_next``: ``obs_next`` is not stored; sampling rebuilds
          it as the observation at ``next(pos)`` (which repeats the current
          one at an episode end, where the bootstrap is masked anyway).
        - ``sample_avail``: with ``stack_num > 1``, sample only slots whose
          whole frame stack lies within one episode.
        """
        if capacity <= 0 or num_envs <= 0 or stack_num < 1:
            raise ValueError("capacity and num_envs must be positive and stack_num >= 1")
        self.capacity = capacity
        self.num_envs = num_envs
        self.stack_num = stack_num
        self.save_only_last_obs = save_only_last_obs
        self.ignore_obs_next = ignore_obs_next
        self.sample_avail = sample_avail

    # -- storage-layout transform (memory options) ---------------------------
    def _to_storage_layout(self, transition: Any, batched: bool) -> Any:
        """Apply the memory options to an incoming transition: keep only the
        newest frame of stacked observations and/or drop ``obs_next``.
        ``batched`` selects between ``[num_envs, ...]`` leaves (add path)
        and bare single-transition leaves (init example)."""
        if not (self.save_only_last_obs or self.ignore_obs_next):
            return transition
        tr = dict(transition)
        if self.save_only_last_obs:
            for k in ("obs", "obs_next"):
                if k in tr:
                    tr[k] = tr[k][:, -1] if batched else tr[k][-1]
        if self.ignore_obs_next:
            tr.pop("obs_next", None)
        return type(transition)(tr)

    # -- construction ------------------------------------------------------
    def init(self, example_transition: Batch, device: str | torch.device = "cuda") -> ReplayBufferState:
        """Allocate zeroed storage from a single-step example (leaves shaped
        like one env's transition, no leading batch dims; with
        ``save_only_last_obs`` the example obs carries its frame-stack axis,
        which storage drops)."""
        dev = resolve_device(device)
        example = self._to_storage_layout(example_transition, batched=False)
        storage = tree_map(
            lambda x: torch.zeros((self.num_envs, self.capacity) + tuple(x.shape), dtype=x.dtype, device=dev),
            example,
        )
        return ReplayBufferState(storage=storage, cursor=self._zeros(dev), size=self._zeros(dev))

    def _zeros(self, device: torch.device) -> torch.Tensor:
        return torch.zeros((self.num_envs,), dtype=torch.int64, device=device)

    # -- writing -----------------------------------------------------------
    def add(self, state: ReplayBufferState, transition: Batch) -> ReplayBufferState:
        """Write one transition per env (leaves ``[num_envs, ...]``) in place;
        returns the state with the advanced cursors."""
        transition = self._to_storage_layout(transition, batched=True)
        env_ids = torch.arange(self.num_envs, device=state.cursor.device)
        _write(state.storage, transition, env_ids, state.cursor, None)
        # ``replace`` keeps a subclass state's own fields (the PER tree)
        return dataclasses.replace(
            state,
            cursor=torch.remainder(state.cursor + 1, self.capacity),
            size=torch.clamp(state.size + 1, max=self.capacity),
        )

    def add_masked(
        self,
        state: ReplayBufferState,
        transition: Batch,
        mask: torch.Tensor,
        in_storage_layout: bool = False,
    ) -> ReplayBufferState:
        """Write one transition for the envs where ``mask [num_envs]`` is
        True only (asynchronous collection).  ``in_storage_layout`` skips the
        memory-option transform for values already in storage layout (the
        :meth:`merge` path)."""
        if not in_storage_layout:
            transition = self._to_storage_layout(transition, batched=True)
        mask = mask.to(torch.bool)
        env_ids = torch.arange(self.num_envs, device=state.cursor.device)
        _write(state.storage, transition, env_ids, state.cursor, mask)
        inc = mask.to(torch.int64)
        return dataclasses.replace(
            state,
            cursor=torch.remainder(state.cursor + inc, self.capacity),
            size=torch.clamp(state.size + inc, max=self.capacity),
        )

    def add_trajectory(self, state: ReplayBufferState, traj: Batch) -> ReplayBufferState:
        """Write a whole ``[T, num_envs, ...]`` rollout, one step at a time."""
        for t in range(tree_leaves(traj)[0].shape[0]):
            state = self.add(state, tree_map(lambda x: x[t], traj))
        return state

    # -- ring-position arithmetic -----------------------------------------
    def _done(self, state: ReplayBufferState, env: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        s = state.storage
        return (s["terminated"][env, pos] | s["truncated"][env, pos]).to(torch.bool)

    def next_pos(self, state: ReplayBufferState, env: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """Episode-aware successor slot: stays put at episode ends and at the
        newest written entry."""
        newest = torch.remainder(state.cursor[env] - 1, self.capacity)
        stop = self._done(state, env, pos) | (pos == newest)
        return torch.where(stop, pos, torch.remainder(pos + 1, self.capacity))

    def prev_pos(self, state: ReplayBufferState, env: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """Episode-aware predecessor slot: stays put at episode starts
        (previous transition done) and at the oldest entry."""
        oldest = torch.remainder(state.cursor[env] - state.size[env], self.capacity)
        prev = torch.remainder(pos - 1, self.capacity)
        stop = self._done(state, env, prev) | (pos == oldest)
        return torch.where(stop, pos, prev)

    # -- sampling ----------------------------------------------------------
    def sample_indices(
        self, state: ReplayBufferState, generator: torch.Generator, batch_size: int
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Uniform ``(env_idx, pos)`` over all valid entries across envs, or,
        with ``sample_avail`` and ``stack_num > 1``, over the slots that
        :meth:`_avail_mask` admits.

        Counts stay on the device: a float64 uniform scaled by the count
        replaces ``randint(0, total)``, so sampling makes no host sync.
        """
        if self.sample_avail and self.stack_num > 1:
            cum = torch.cumsum(self._avail_mask(state).reshape(-1).to(torch.int64), 0)
            flat = torch.searchsorted(cum, self._uniform_below(cum[-1], generator, batch_size), right=True)
            flat = torch.clamp(flat, max=self.num_envs * self.capacity - 1)
            return flat // self.capacity, flat % self.capacity
        sizes = state.size
        bounds = torch.cumsum(sizes, 0)
        flat = self._uniform_below(bounds[-1], generator, batch_size)
        env_idx = torch.searchsorted(bounds, flat, right=True)
        env_idx = torch.clamp(env_idx, max=self.num_envs - 1)
        before = torch.where(env_idx > 0, bounds[env_idx - 1], 0)
        offset_in_env = flat - before
        # age-ordered offset -> ring position
        start = torch.remainder(state.cursor[env_idx] - sizes[env_idx], self.capacity)
        pos = torch.remainder(start + offset_in_env, self.capacity)
        return env_idx, pos

    @staticmethod
    def _uniform_below(count: torch.Tensor, generator: torch.Generator, n: int) -> torch.Tensor:
        """``n`` uniform int64 draws from ``[0, max(count, 1))`` for a count
        that stays on the device."""
        total = torch.clamp(count, min=1)
        u = torch.rand((n,), generator=generator, device=count.device, dtype=torch.float64)
        return torch.minimum((u * total).to(torch.int64), total - 1)

    def _avail_mask(self, state: ReplayBufferState) -> torch.Tensor:
        """``[num_envs, capacity]`` bool: slots holding a complete in-episode
        frame stack.  A slot qualifies when the ``prev`` chain makes
        ``stack_num - 1`` real (non-saturating) steps; it saturates at
        episode starts and at the oldest entry, the cases the reference
        excludes."""
        dev = state.cursor.device
        env = torch.arange(self.num_envs, device=dev).repeat_interleave(self.capacity)
        pos = torch.arange(self.capacity, device=dev).repeat(self.num_envs)
        steps = torch.zeros_like(pos)
        cur = pos
        for _ in range(self.stack_num - 1):
            prv = self.prev_pos(state, env, cur)
            steps = steps + (prv != cur).to(pos.dtype)
            cur = prv
        valid_slot = torch.arange(self.capacity, device=dev)[None, :] < self._age_limit(state)[:, None]
        full_stack = (steps == self.stack_num - 1).reshape(self.num_envs, self.capacity)
        return valid_slot & full_stack

    def _age_limit(self, state: ReplayBufferState) -> torch.Tensor:
        """Per-env count below which a raw ring slot holds valid data: every
        slot once the ring is full, else slots ``[0, size)`` (writes start
        at 0)."""
        return torch.where(state.size >= self.capacity, self.capacity, state.size)

    def sample_with_weights(
        self, state: ReplayBufferState, generator: torch.Generator, batch_size: int
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Uniform sampling: importance weights are all ones."""
        env_idx, pos = self.sample_indices(state, generator, batch_size)
        return env_idx, pos, torch.ones((batch_size,), device=pos.device)

    def update_priorities(
        self,
        state: ReplayBufferState,
        env_idx: torch.Tensor,
        pos: torch.Tensor,
        td_abs: torch.Tensor,
    ) -> ReplayBufferState:
        """No-op for uniform replay; :class:`PrioritizedReplayBuffer`
        writes the priorities into its sum tree."""
        return state

    def get(
        self,
        state: ReplayBufferState,
        env_idx: torch.Tensor,
        pos: torch.Tensor,
        keys: tuple[str, ...] | None = None,
        dtypes: dict[str, torch.dtype] | None = None,
    ) -> Batch:
        """Gather transitions at ``(env_idx, pos)``; adds derived ``done``.

        With ``stack_num > 1``, ``obs`` and ``obs_next`` come back stacked
        ``[B, stack_num, ...]``, oldest frame first; with
        ``ignore_obs_next``, ``obs_next`` is rebuilt as the observation
        (stack) ending at ``next(pos)``.  ``dtypes`` maps a key to the dtype
        to return it in; a uint8 leaf asked for in bfloat16 (pixels for a
        bf16 network) goes through :func:`gather_rows_cast`, which gathers
        and decodes the rows, whole stacks included, in one launch.
        """
        if keys is None:
            keys = tuple(state.storage.keys())
            if self.ignore_obs_next and "obs_next" not in keys:
                keys = keys + ("obs_next",)
        dtypes = dtypes or {}
        stacked = self.stack_num > 1
        out = Batch()
        for k in keys:
            dt = dtypes.get(k)
            if k == "obs" and stacked:
                out[k] = self.stacked_obs(state, env_idx, pos, dtype=dt)
            elif k == "obs_next" and self.ignore_obs_next:
                nxt = self.next_pos(state, env_idx, pos)
                out[k] = (
                    self.stacked_obs(state, env_idx, nxt, dtype=dt)
                    if stacked
                    else self._gather(state.storage["obs"], env_idx, nxt, dt)
                )
            elif k == "obs_next" and stacked:
                out[k] = self.stacked_obs(state, env_idx, pos, obs_key="obs_next", dtype=dt)
            else:
                out[k] = self._gather(state.storage[k], env_idx, pos, dt)
        if "terminated" in out and "truncated" in out:
            out["done"] = out["terminated"] | out["truncated"]
        return out

    @staticmethod
    def _gather(leaf: Any, env_idx: torch.Tensor, pos: torch.Tensor, dtype: torch.dtype | None) -> Any:
        """``leaf[env_idx, pos]`` for index tensors of any (equal) shape."""
        if isinstance(leaf, dict):
            return tree_map(lambda x: x[env_idx, pos], leaf)
        if dtype == torch.bfloat16 and leaf.dtype == torch.uint8:
            num_envs, capacity = leaf.shape[:2]
            rows = leaf.reshape(num_envs * capacity, -1)
            flat = env_idx * capacity + pos
            return gather_rows_cast(rows, flat.reshape(-1)).reshape(flat.shape + leaf.shape[2:])
        out = leaf[env_idx, pos]
        return out if dtype is None else out.to(dtype)

    # -- n-step chains -----------------------------------------------------
    def nstep_chain(
        self,
        state: ReplayBufferState,
        env_idx: torch.Tensor,
        pos: torch.Tensor,
        n_step: int,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Walk ``next_pos`` from each sampled index.

        Returns ``(rew_chain [B, n], done_chain [B, n] int32,
        terminal_pos [B])``, the input of
        :func:`tianshou_tpu_torch.ops.returns.nstep_return`.
        """
        s = state.storage
        done = (s["terminated"] | s["truncated"]).to(torch.int32)
        rews, dones = [], []
        cur = pos
        for _ in range(n_step):
            rews.append(s["rew"][env_idx, cur])
            dones.append(done[env_idx, cur])
            cur = self.next_pos(state, env_idx, cur)
        return torch.stack(rews, dim=1), torch.stack(dones, dim=1), cur

    # -- frame stacking ----------------------------------------------------
    def stacked_obs(
        self,
        state: ReplayBufferState,
        env_idx: torch.Tensor,
        pos: torch.Tensor,
        stack_num: int | None = None,
        obs_key: str = "obs",
        dtype: torch.dtype | None = None,
    ) -> Any:
        """The last ``stack_num`` observations ending at ``pos``,
        ``[B, stack_num, ...]`` with the oldest frame first; saturates at
        episode starts (repeating the first frame).

        The ``[B, stack_num]`` position chain is gathered in one go, so a
        bf16 stack of uint8 frames is one :func:`gather_rows_cast` launch of
        ``B * stack_num`` rows.
        """
        k = stack_num or self.stack_num
        positions = [pos]
        cur = pos
        for _ in range(k - 1):
            cur = self.prev_pos(state, env_idx, cur)
            positions.append(cur)
        chain = torch.stack(positions[::-1], dim=1)  # [B, k], oldest first
        env = env_idx[:, None].expand_as(chain)
        return self._gather(state.storage[obs_key], env, chain, dtype)

    # -- merging / construction from datasets -------------------------------
    def merge(self, state: ReplayBufferState, src: ReplayBuffer, src_state: ReplayBufferState) -> ReplayBufferState:
        """Copy every valid entry of ``src_state`` (oldest first, per env)
        into ``state``, as repeated :meth:`add` calls would: overflow evicts
        the oldest entries of ``state``.  Requires equal ``num_envs`` and
        storage keys."""
        if src.num_envs != self.num_envs:
            raise ValueError(f"merge requires equal num_envs, got {src.num_envs} and {self.num_envs}")
        env_ids = torch.arange(self.num_envs, device=state.cursor.device)
        start = torch.remainder(src_state.cursor - src_state.size, src.capacity)
        for t in range(src.capacity):
            pos = torch.remainder(start + t, src.capacity)
            tr = tree_map(lambda x: x[env_ids, pos], src_state.storage)
            state = self.add_masked(state, tr, t < src_state.size, in_storage_layout=True)
        return state

    @classmethod
    def from_data(
        cls, data: Batch, stack_num: int = 1, device: str | torch.device = "cuda"
    ) -> tuple[ReplayBuffer, ReplayBufferState]:
        """A single-env buffer of capacity ``N``, exactly full, from a
        dataset whose leaves are ``[N, ...]`` (e.g. loaded from HDF5)."""
        dev = resolve_device(device)
        n = tree_leaves(data)[0].shape[0]
        buf = cls(capacity=n, num_envs=1, stack_num=stack_num)
        storage = tree_map(lambda x: torch.as_tensor(x, device=dev)[None].clone(), data)
        cursor = torch.zeros((1,), dtype=torch.int64, device=dev)
        return buf, ReplayBufferState(storage=storage, cursor=cursor, size=torch.full_like(cursor, n))

    # -- bulk views --------------------------------------------------------
    def chronological(self, state: ReplayBufferState) -> Batch:
        """The whole ring in time order per env: leaves
        ``[capacity, num_envs, ...]``.  Meaningful when every env holds
        ``capacity`` entries (the on-policy full-buffer pattern)."""
        dev = state.cursor.device
        t = torch.arange(self.capacity, device=dev)
        pos = torch.remainder(state.cursor[None, :] + t[:, None], self.capacity)  # [T, N]
        env = torch.arange(self.num_envs, device=dev)[None, :].expand_as(pos)
        return tree_map(lambda x: x[env, pos], state.storage)
