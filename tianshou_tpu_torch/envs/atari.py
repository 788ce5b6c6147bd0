"""DeepMind-style Atari preprocessing for host envs (port of
``tianshou_tpu/envs/atari.py``).

The chain of the reference's flagship pixel pipeline on the gymnasium
5-tuple API, for :class:`~tianshou_tpu_torch.envs.host.HostVectorEnv`:

``NoopResetEnv`` (random no-ops on reset) -> ``MaxAndSkipEnv`` (frame skip
with a max-pool of the last two frames) -> ``EpisodicLifeEnv`` (a lost life
ends the episode, the game resets only at game over) -> ``FireResetEnv`` ->
``WarpFrame`` (grayscale, 84x84 area resize) -> ``ScaledFloatFrame``
(optional) -> ``ClipRewardEnv`` (sign) -> ``FrameStack`` (channel-first
``[stack, H, W]``).

Stacked observations pair with a ``ReplayBuffer(stack_num=k,
save_only_last_obs=True, ignore_obs_next=True)``, which stores each 84x84
frame once and rebuilds stacks at sample time.

``WarpFrame`` computes OpenCV's ``cvtColor(RGB2GRAY)`` and
``resize(INTER_AREA)`` in numpy (:func:`warp_frame`), bit for bit: the port
needs no ``cv2``.  Spaces are the port's own.  ``gymnasium`` is imported
only by :func:`make_atari_env` when it must build an ALE env from a task
id; :class:`FakeAtariEnv`, a deterministic ALE double, stands in for ALE
where it is not installed.
"""

from __future__ import annotations

import functools
import math
from collections import deque

import numpy as np

from tianshou_tpu_torch.envs.host import HostVectorEnv
from tianshou_tpu_torch.envs.spaces import Box, Discrete

__all__ = [
    "NoopResetEnv",
    "MaxAndSkipEnv",
    "EpisodicLifeEnv",
    "FireResetEnv",
    "WarpFrame",
    "ScaledFloatFrame",
    "ClipRewardEnv",
    "FrameStack",
    "wrap_deepmind",
    "make_atari_env",
    "FakeAtariEnv",
    "warp_frame",
]


# -- OpenCV's grayscale and INTER_AREA resize, in numpy ----------------------


@functools.cache
def _area_table(ssize: int, dsize: int) -> tuple[np.ndarray, np.ndarray]:
    """OpenCV's ``computeResizeAreaTab`` (``imgproc/src/resize.cpp``) for one
    axis, as ``(src [dsize, taps], weight [dsize, taps] float32)``: for each
    destination index the source indices it overlaps, in order, each with
    the weight ``overlap / cell``, padded with zero-weight taps.  The scale
    is OpenCV's double ``1 / (dsize / ssize)``."""
    scale = 1.0 / (dsize / ssize)
    rows: list[list[tuple[int, float]]] = []
    for d in range(dsize):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, ssize - f1)
        s2 = min(math.floor(f2), ssize - 1)
        s1 = min(math.ceil(f1), s2)
        taps = []
        if s1 - f1 > 1e-3:
            taps.append((s1 - 1, (s1 - f1) / cell))
        taps += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            taps.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        rows.append(taps)
    width = max(len(t) for t in rows)
    src = np.zeros((dsize, width), np.int64)
    weight = np.zeros((dsize, width), np.float32)
    for d, taps in enumerate(rows):
        for j, (s, w) in enumerate(taps):
            src[d, j], weight[d, j] = s, np.float32(w)
    return src, weight


def warp_frame(frame: np.ndarray, size: int = 84) -> np.ndarray:
    """``cv2.resize(cv2.cvtColor(frame, COLOR_RGB2GRAY), (size, size),
    interpolation=INTER_AREA)`` for a ``[H, W, 3]`` uint8 RGB frame.

    Grayscale is OpenCV's 15-bit fixed point, rounded.  The resize follows
    ``ResizeArea_Invoker``: per source row, a float32 sum over the
    horizontal taps in table order; per destination row, the first source
    row's weighted sum assigned and the others added, in float32; then
    rounded half to even and saturated to uint8.
    """
    rgb = frame.astype(np.int32)
    gray = ((rgb[..., 0] * 9798 + rgb[..., 1] * 19235 + rgb[..., 2] * 3735 + 16384) >> 15).astype(np.float32)
    xs, xw = _area_table(gray.shape[1], size)
    ys, yw = _area_table(gray.shape[0], size)
    rows = gray[:, xs[:, 0]] * xw[:, 0]
    for j in range(1, xs.shape[1]):
        rows = rows + gray[:, xs[:, j]] * xw[:, j]
    out = rows[ys[:, 0]] * yw[:, 0, None]
    for j in range(1, ys.shape[1]):
        out = out + rows[ys[:, j]] * yw[:, j, None]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


# -- the wrappers ---------------------------------------------------------


class _Wrapper:
    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset(self, **kwargs):
        return self.env.reset(**kwargs)

    def step(self, action):
        return self.env.step(action)


class NoopResetEnv(_Wrapper):
    """Start each episode after 1..``noop_max`` random no-ops (action 0)."""

    def __init__(self, env, noop_max: int = 30):
        super().__init__(env)
        self.noop_max = noop_max
        self.noop_action = 0
        if env.unwrapped.get_action_meanings()[0] != "NOOP":
            raise ValueError("NoopResetEnv needs action 0 to be NOOP")

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        noops = int(self.env.unwrapped.np_random.integers(1, self.noop_max + 1))
        for _ in range(noops):
            obs, _, term, trunc, info = self.env.step(self.noop_action)
            if term or trunc:
                obs, info = self.env.reset()
        return obs, info


class MaxAndSkipEnv(_Wrapper):
    """Repeat the action ``skip`` times, sum the rewards, and max-pool the
    last two raw frames (removes ALE's sprite flicker)."""

    def __init__(self, env, skip: int = 4):
        super().__init__(env)
        self._skip = skip

    def step(self, action):
        frames, total = [], 0.0
        term = trunc = False
        info: dict = {}
        for _ in range(self._skip):
            obs, reward, term, trunc, info = self.env.step(action)
            frames.append(obs)
            total += float(reward)
            if term or trunc:
                break
        return np.max(frames[-2:], axis=0), total, term, trunc, info


class EpisodicLifeEnv(_Wrapper):
    """A lost life ends the episode; the game itself resets only at a real
    game over."""

    def __init__(self, env):
        super().__init__(env)
        self.lives = 0
        self.was_real_done = True

    def step(self, action):
        obs, reward, term, trunc, info = self.env.step(action)
        self.was_real_done = term or trunc
        lives = self.env.unwrapped.ale.lives()
        # lives > 0: some games sit at 0 lives for a few frames before the
        # real game over
        if 0 < lives < self.lives:
            term = True
        self.lives = lives
        return obs, float(reward), term, trunc, info

    def reset(self, **kwargs):
        if self.was_real_done:
            obs, info = self.env.reset(**kwargs)
        else:
            # a no-op past the lost life; should it end the game, reset
            # for real rather than return a terminal state
            obs, _, term, trunc, info = self.env.step(0)
            if term or trunc:
                obs, info = self.env.reset(**kwargs)
                self.was_real_done = True
        self.lives = self.env.unwrapped.ale.lives()
        return obs, info


class FireResetEnv(_Wrapper):
    """Press FIRE on reset, for games that wait for it."""

    def __init__(self, env):
        super().__init__(env)
        meanings = env.unwrapped.get_action_meanings()
        if meanings[1] != "FIRE" or len(meanings) < 3:
            raise ValueError("FireResetEnv needs action 1 to be FIRE and at least 3 actions")

    def reset(self, **kwargs):
        self.env.reset(**kwargs)
        obs, _, term, trunc, info = self.env.step(1)
        if term or trunc:
            obs, info = self.env.reset(**kwargs)
        return obs, info


class WarpFrame(_Wrapper):
    """Grayscale + ``size`` x ``size`` area resize (:func:`warp_frame`)."""

    def __init__(self, env, size: int = 84):
        super().__init__(env)
        self.size = size
        self.observation_space = Box(low=0.0, high=255.0, shape=(size, size))

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        return warp_frame(obs, self.size), info

    def step(self, action):
        obs, reward, term, trunc, info = self.env.step(action)
        return warp_frame(obs, self.size), reward, term, trunc, info


class ScaledFloatFrame(_Wrapper):
    """uint8 frames as float32 in [0, 1] (off by default: it quadruples the
    buffer's memory)."""

    def __init__(self, env):
        super().__init__(env)
        self.observation_space = Box(low=0.0, high=1.0, shape=env.observation_space.shape)

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        return np.asarray(obs, np.float32) / 255.0, info

    def step(self, action):
        obs, reward, term, trunc, info = self.env.step(action)
        return np.asarray(obs, np.float32) / 255.0, reward, term, trunc, info


class ClipRewardEnv(_Wrapper):
    """Rewards clipped to their sign."""

    def step(self, action):
        obs, reward, term, trunc, info = self.env.step(action)
        return obs, float(np.sign(float(reward))), term, trunc, info


class FrameStack(_Wrapper):
    """The last ``n_frames`` observations stacked channel-first ``[k, H, W]``;
    a reset repeats the first frame."""

    def __init__(self, env, n_frames: int = 4):
        super().__init__(env)
        self.n_frames = n_frames
        self.frames: deque = deque([], maxlen=n_frames)
        space = env.observation_space
        self.observation_space = Box(low=float(np.min(space.low)), high=float(np.max(space.high)),
                                     shape=(n_frames, *space.shape))

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        for _ in range(self.n_frames):
            self.frames.append(obs)
        return np.stack(self.frames, axis=0), info

    def step(self, action):
        obs, reward, term, trunc, info = self.env.step(action)
        self.frames.append(obs)
        return np.stack(self.frames, axis=0), reward, term, trunc, info


def wrap_deepmind(
    env,
    episode_life: bool = True,
    clip_rewards: bool = True,
    frame_stack: int = 4,
    scale: bool = False,
    warp_frame: bool = True,
):
    """The DeepMind chain: no-op reset, 4-frame max-skip, optional episodic
    life, FIRE reset when the game has FIRE, 84x84 grayscale warp, optional
    [0, 1] scaling, sign reward clip, channel-first frame stack."""
    env = NoopResetEnv(env, noop_max=30)
    env = MaxAndSkipEnv(env, skip=4)
    if episode_life:
        env = EpisodicLifeEnv(env)
    if "FIRE" in env.unwrapped.get_action_meanings():
        env = FireResetEnv(env)
    if warp_frame:
        env = WarpFrame(env)
    if scale:
        env = ScaledFloatFrame(env)
    if clip_rewards:
        env = ClipRewardEnv(env)
    if frame_stack:
        env = FrameStack(env, frame_stack)
    return env


def make_atari_env(
    task: str,
    num_train_envs: int,
    num_test_envs: int,
    *,
    frame_stack: int = 4,
    scale: bool = False,
    env_fn=None,
) -> tuple[HostVectorEnv, HostVectorEnv]:
    """``(train, test)`` :class:`HostVectorEnv`\\ s over the wrapped chain:
    training envs with episodic life and reward clipping, test envs with
    the raw episodes.  ``env_fn`` builds the base env (e.g.
    :class:`FakeAtariEnv`); without it ``gymnasium.make(task,
    frameskip=1)`` does, which needs ``ale_py`` and the ROMs."""
    if env_fn is None:

        def env_fn():
            import gymnasium as gym

            try:
                return gym.make(task, frameskip=1)
            except Exception as e:
                raise RuntimeError(
                    f"cannot construct Atari env {task!r}: ALE (ale_py and its ROMs) is not installed ({e}); "
                    "pass env_fn= or install ale_py"
                ) from e

    def train_fn():
        return wrap_deepmind(env_fn(), episode_life=True, clip_rewards=True, frame_stack=frame_stack, scale=scale)

    def test_fn():
        return wrap_deepmind(env_fn(), episode_life=False, clip_rewards=False, frame_stack=frame_stack, scale=scale)

    return (HostVectorEnv([train_fn] * num_train_envs), HostVectorEnv([test_fn] * num_test_envs))


# -- the ALE double -----------------------------------------------------------


class _FakeALE:
    def __init__(self, env):
        self._env = env

    def lives(self) -> int:
        return self._env._lives


class FakeAtariEnv:
    """Deterministic ALE double: 210x160x3 uint8 frames, NOOP/FIRE/moves,
    lives that drain on a fixed schedule: the surface every wrapper above
    reads (``get_action_meanings``, ``ale.lives``, ``np_random``).

    A paddle column follows the action; a frame is a function of (step,
    paddle), the paddle drawn on even steps only (flicker).  Reward +1
    every ``reward_every`` steps once FIRE was pressed; one life lost every
    ``life_len`` steps; game over at zero lives; truncation at
    ``max_steps``.
    """

    metadata: dict = {}

    def __init__(self, lives: int = 3, life_len: int = 25, reward_every: int = 7, max_steps: int = 400,
                 seed: int = 0):
        self.observation_space = Box(low=0.0, high=255.0, shape=(210, 160, 3))
        self.action_space = Discrete(6)
        self._start_lives = lives
        self.life_len = life_len
        self.reward_every = reward_every
        self.max_steps = max_steps
        self.np_random = np.random.default_rng(seed)
        self.ale = _FakeALE(self)
        self.unwrapped = self
        self._lives = lives
        self._t = 0
        self._paddle = 80
        self._fired = False

    def get_action_meanings(self):
        return ["NOOP", "FIRE", "UP", "RIGHT", "LEFT", "DOWN"]

    def _frame(self) -> np.ndarray:
        obs = np.full((210, 160, 3), (self._t * 3) % 32, np.uint8)
        if self._t % 2 == 0:
            obs[100:110, self._paddle:self._paddle + 8] = 255
        obs[0:10, :16 * self._lives] = 200  # the lives strip
        return obs

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self.np_random = np.random.default_rng(seed)
        self._lives = self._start_lives
        self._t = 0
        self._paddle = 80
        self._fired = False
        return self._frame(), {}

    def step(self, action):
        action = int(action)
        self._t += 1
        if action == 1:
            self._fired = True
        elif action == 3:
            self._paddle = min(self._paddle + 4, 152)
        elif action == 4:
            self._paddle = max(self._paddle - 4, 0)
        reward = 1.0 if self._fired and self._t % self.reward_every == 0 else 0.0
        if self._t % self.life_len == 0:
            self._lives -= 1
        terminated = self._lives <= 0
        truncated = self._t >= self.max_steps and not terminated
        return self._frame(), reward, terminated, truncated, {}

    def close(self):
        pass
