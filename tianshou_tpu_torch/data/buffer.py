"""Device-resident ring replay buffer (port of the core of
``tianshou_tpu/data/buffer.py``).

Storage leaves are ``[num_envs, capacity, ...]`` tensors on the buffer's
device, with ``[num_envs]`` int64 cursors (next write slot) and sizes
(valid entries).  Index semantics are the JAX package's, which mirror the
reference's:
- per-env circular writes;
- episode-aware ``next``: saturates at an episode end or at the newest entry;
- episode-aware ``prev``: saturates at an episode start or the oldest entry.

Ring arithmetic uses ``torch.remainder`` (Python-style ``%``; ``fmod`` would
keep the sign of a negative position).  Unlike the JAX package, whose state
is immutable, :meth:`ReplayBuffer.add` writes the storage in place: a copy
of a pixel ring per step would cost as much memory as the ring itself.

The memory options (``stack_num``, ``save_only_last_obs``,
``ignore_obs_next``, ``sample_avail``) and ``merge`` are for a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.tree import tree_map
from tianshou_tpu_torch.ops.gather import gather_rows_cast
from tianshou_tpu_torch.utils.device import resolve_device

__all__ = ["ReplayBuffer", "ReplayBufferState"]


@dataclasses.dataclass
class ReplayBufferState:
    storage: Batch
    cursor: torch.Tensor  # [num_envs] int64
    size: torch.Tensor  # [num_envs] int64


def _write(buf: Any, val: Any, env_ids: torch.Tensor, cursor: torch.Tensor) -> None:
    if isinstance(buf, dict):
        for k, b in buf.items():
            _write(b, val[k], env_ids, cursor)
    else:
        buf[env_ids, cursor] = val


class ReplayBuffer:
    """Static configuration + ops over :class:`ReplayBufferState`.

    Storage keys: ``obs, act, rew, terminated, truncated, obs_next`` plus any
    extras; ``done`` is derived, not stored.
    """

    def __init__(self, capacity: int, num_envs: int = 1):
        if capacity <= 0 or num_envs <= 0:
            raise ValueError("capacity and num_envs must be positive")
        self.capacity = capacity
        self.num_envs = num_envs

    # -- construction ------------------------------------------------------
    def init(
        self, example_transition: Batch, device: str | torch.device = "cuda"
    ) -> ReplayBufferState:
        """Allocate zeroed storage from a single-step example (leaves shaped
        like one env's transition, no leading batch dims)."""
        dev = resolve_device(device)
        storage = tree_map(
            lambda x: torch.zeros(
                (self.num_envs, self.capacity) + tuple(x.shape),
                dtype=x.dtype, device=dev,
            ),
            example_transition,
        )
        zeros = torch.zeros((self.num_envs,), dtype=torch.int64, device=dev)
        return ReplayBufferState(storage=storage, cursor=zeros, size=zeros.clone())

    # -- writing -----------------------------------------------------------
    def add(self, state: ReplayBufferState, transition: Batch) -> ReplayBufferState:
        """Write one transition per env (leaves ``[num_envs, ...]``) in place;
        returns the state with the advanced cursors."""
        env_ids = torch.arange(self.num_envs, device=state.cursor.device)
        _write(state.storage, transition, env_ids, state.cursor)
        return ReplayBufferState(
            storage=state.storage,
            cursor=torch.remainder(state.cursor + 1, self.capacity),
            size=torch.clamp(state.size + 1, max=self.capacity),
        )

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
        """Uniform ``(env_idx, pos)`` over all valid entries across envs.

        The total count stays on the device: a float64 uniform scaled by it
        replaces ``randint(0, total)``, so sampling makes no host sync.
        """
        sizes = state.size
        total = torch.clamp(sizes.sum(), min=1)
        u = torch.rand(
            (batch_size,), generator=generator, device=sizes.device,
            dtype=torch.float64,
        )
        flat = torch.minimum((u * total).to(torch.int64), total - 1)
        bounds = torch.cumsum(sizes, 0)
        env_idx = torch.searchsorted(bounds, flat, right=True)
        env_idx = torch.clamp(env_idx, max=self.num_envs - 1)
        before = torch.where(env_idx > 0, bounds[env_idx - 1], 0)
        offset_in_env = flat - before
        # age-ordered offset -> ring position
        start = torch.remainder(state.cursor[env_idx] - sizes[env_idx], self.capacity)
        pos = torch.remainder(start + offset_in_env, self.capacity)
        return env_idx, pos

    def sample_with_weights(
        self, state: ReplayBufferState, generator: torch.Generator, batch_size: int
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Uniform sampling: importance weights are all ones."""
        env_idx, pos = self.sample_indices(state, generator, batch_size)
        return env_idx, pos, torch.ones((batch_size,), device=pos.device)

    def get(
        self,
        state: ReplayBufferState,
        env_idx: torch.Tensor,
        pos: torch.Tensor,
        keys: tuple[str, ...] | None = None,
        dtypes: dict[str, torch.dtype] | None = None,
    ) -> Batch:
        """Gather transitions at ``(env_idx, pos)``; adds derived ``done``.

        ``dtypes`` maps a key to the dtype to return it in.  A uint8 leaf
        asked for in bfloat16 (pixel observations for a bf16 network) goes
        through :func:`gather_rows_cast`, which gathers and decodes the rows
        in one pass.
        """
        keys = tuple(state.storage.keys()) if keys is None else keys
        dtypes = dtypes or {}
        out = Batch()
        for k in keys:
            out[k] = self._gather(state.storage[k], env_idx, pos, dtypes.get(k))
        if "terminated" in out and "truncated" in out:
            out["done"] = out["terminated"] | out["truncated"]
        return out

    @staticmethod
    def _gather(
        leaf: Any, env_idx: torch.Tensor, pos: torch.Tensor, dtype: torch.dtype | None
    ) -> Any:
        if isinstance(leaf, dict):
            return tree_map(lambda x: x[env_idx, pos], leaf)
        if dtype == torch.bfloat16 and leaf.dtype == torch.uint8:
            num_envs, capacity = leaf.shape[:2]
            rows = leaf.reshape(num_envs * capacity, -1)
            flat = env_idx * capacity + pos
            return gather_rows_cast(rows, flat).reshape(flat.shape + leaf.shape[2:])
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
