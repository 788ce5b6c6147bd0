"""Remote environment farms: env workers on other machines (port of
``tianshou_tpu/envs/remote.py``).

A farm is a plain TCP server (:func:`serve_envs`, or ``python -m
tianshou_tpu_torch.envs.remote --env module:factory``) hosting a
thread-pooled :class:`~tianshou_tpu_torch.envs.host.HostVectorEnv`.
:class:`RemoteVectorEnv` is the learner's client: it drives one or more
farms at once and has the host-env surface (``num_envs``, ``reset``,
``step -> (HostStepResult, carry)``), so it drops into
:class:`~tianshou_tpu_torch.collect.host_collector.HostCollector` and the
trainers unchanged.

Wire protocol v2, the JAX package's byte for byte (a port client drives a
JAX farm and the other way round), per connection, length-prefixed:

- handshake: server -> client, one JSON document (never pickle: it crosses
  a trust boundary) with ``num_envs``, the space specs and one
  ``[name, shape, dtype]`` descriptor per observation field, probed from a
  real reset, so every later message is raw bytes of a fixed layout;
- ``RESET``: an int64 seed (-1: none) -> the observation fields, each in
  its native dtype (uint8 pixels cross at one byte a pixel);
- ``STEP``: the actions (float32 for ``Box``, int32 for the discrete
  spaces) -> one buffer of (observation fields, reward float32, terminated
  uint8, truncated uint8, carry fields): one round trip a step;
- ``CLOSE``: the farm drops the connection and keeps serving.

Dict observations send one descriptor per key, in sorted order.

Faults: an env that raises inside the farm makes the farm rebuild its
whole fleet from ``env_fns`` and drop the connection; a client whose
connection fails (the farm restarted, the network blipped) reconnects
within ``reconnect_timeout``, checks the handshake again and re-sends the
request.  Requests are therefore at-least-once: a re-sent step acts on
whatever episode state the (possibly new) farm holds.

Every socket has a timeout: the client's connect and each request round
trip, the farm's accept loop and each connection's idle wait.  The protocol
carries no code, but it is unauthenticated: run farms on trusted networks
and bind them to an internal interface.  Farm machines need Python, numpy
and the envs' own packages.
"""

from __future__ import annotations

import json
import socket
import struct
import sys
import threading
import time
from collections.abc import Callable, Sequence
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from tianshou_tpu_torch.envs.host import HostStepResult, HostVectorEnv
from tianshou_tpu_torch.envs.spaces import Box, Discrete, MultiDiscrete

__all__ = ["serve_envs", "RemoteVectorEnv", "FarmMismatchError"]

_PROTO = 2

_CMD_RESET = 1
_CMD_STEP = 2
_CMD_CLOSE = 3


class _EnvCrash(Exception):
    """An exception raised by the hosted envs themselves (not a malformed
    request): the farm rebuilds its fleet."""


class FarmMismatchError(RuntimeError):
    """A handshake no retry can fix: another protocol version, or a farm
    whose fleet changed shape across a reconnect."""


def _send_msg(sock: socket.socket, cmd: int, payload: bytes) -> None:
    sock.sendall(struct.pack("<II", cmd, len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("remote env farm closed the connection")
        buf.extend(chunk)
    return bytes(buf)


def _recv_msg(sock: socket.socket) -> tuple[int, bytes]:
    cmd, ln = struct.unpack("<II", _recv_exact(sock, 8))
    return cmd, _recv_exact(sock, ln)


# -- JSON space specs ----------------------------------------------------------


def _space_to_json(space) -> dict:
    if isinstance(space, Discrete):
        return {"type": "discrete", "n": space.n}
    if isinstance(space, MultiDiscrete):
        return {"type": "multidiscrete", "nvec": list(space.nvec)}
    if isinstance(space, Box):
        low = space.low if isinstance(space.low, float) else list(space.low)
        high = space.high if isinstance(space.high, float) else list(space.high)
        return {"type": "box", "low": low, "high": high, "shape": list(space.shape)}
    if isinstance(space, dict):
        return {"type": "dict", "fields": {k: _space_to_json(v) for k, v in space.items()}}
    raise TypeError(f"cannot encode space {space!r} for the farm handshake")


def _space_from_json(d: dict):
    t = d["type"]
    if t == "discrete":
        return Discrete(int(d["n"]))
    if t == "multidiscrete":
        return MultiDiscrete(tuple(int(n) for n in d["nvec"]))
    if t == "box":
        def bound(b):
            return float(b) if isinstance(b, (int, float)) else tuple(b)

        return Box(low=bound(d["low"]), high=bound(d["high"]), shape=tuple(d["shape"]))
    if t == "dict":
        return {k: _space_from_json(v) for k, v in d["fields"].items()}
    raise ValueError(f"unknown space type {t!r} in farm handshake")


# -- observation layout ---------------------------------------------------------


class _ObsCodec:
    """The fixed byte layout of a (possibly dict) stacked observation:
    ``fields`` is ``[(name or None, one env's shape, dtype name), ...]``,
    probed by the farm and sent in the handshake."""

    def __init__(self, fields: Sequence[tuple], num_envs: int):
        self.fields = [(n, tuple(int(s) for s in sh), str(dt)) for n, sh, dt in fields]
        self.num_envs = num_envs
        self.is_dict = self.fields[0][0] is not None

    @classmethod
    def probe(cls, obs, num_envs: int) -> _ObsCodec:
        if isinstance(obs, dict):
            fields = [(k, np.asarray(obs[k]).shape[1:], np.asarray(obs[k]).dtype.name) for k in sorted(obs)]
        else:
            a = np.asarray(obs)
            fields = [(None, a.shape[1:], a.dtype.name)]
        return cls(fields, num_envs)

    def pack(self, obs) -> bytes:
        return b"".join(np.ascontiguousarray(obs[name] if name is not None else obs, np.dtype(dt)).tobytes()
                        for name, _, dt in self.fields)

    def unpack(self, buf: bytes, off: int = 0):
        out = {}
        for name, sh, dt in self.fields:
            dtype = np.dtype(dt)
            count = self.num_envs * int(np.prod(sh, dtype=np.int64))
            out[name] = np.frombuffer(buf, dtype, count=count, offset=off).reshape((self.num_envs, *sh)).copy()
            off += count * dtype.itemsize
        return (out if self.is_dict else out[None]), off


def _pack_step(codec: _ObsCodec, res: HostStepResult, carry) -> bytes:
    return b"".join([
        codec.pack(res.obs),
        np.asarray(res.reward, np.float32).tobytes(),
        np.asarray(res.terminated, np.uint8).tobytes(),
        np.asarray(res.truncated, np.uint8).tobytes(),
        codec.pack(carry),
    ])


def _action_dtype(space) -> type:
    return np.int32 if isinstance(space, (Discrete, MultiDiscrete)) else np.float32


# -- the farm -----------------------------------------------------------------


def serve_envs(
    env_fns: Sequence[Callable],
    port: int = 0,
    host: str = "0.0.0.0",
    max_connections: int = 16,
    on_bound: Callable[[int], None] | None = None,
    stop: threading.Event | None = None,
    idle_timeout: float = 300.0,
) -> None:
    """Host ``len(env_fns)`` envs and serve reset and step requests until
    ``stop`` is set (forever without one).

    ``port`` 0 binds a free port; ``on_bound`` receives the port bound.
    One learner connection at a time drives the envs, and the fleet
    persists across connections.  An env that raises rebuilds the fleet
    from ``env_fns`` and drops the connection (the client reconnects and
    re-sends).  A connection idle for ``idle_timeout`` seconds is dropped.
    Farms are unauthenticated: bind to a trusted interface.
    """
    env_fns = list(env_fns)
    venv = HostVectorEnv(env_fns)
    codec = _ObsCodec.probe(venv.reset(), venv.num_envs)
    act_space = venv.action_space
    hello = json.dumps({
        "proto": _PROTO,
        "num_envs": venv.num_envs,
        "observation_space": _space_to_json(venv.observation_space),
        "action_space": _space_to_json(act_space),
        "obs_fields": [[n, list(sh), dt] for n, sh, dt in codec.fields],
    }).encode()
    act_dtype = _action_dtype(act_space)
    act_shape = (venv.num_envs, *act_space.shape)

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(max_connections)
    srv.settimeout(0.5)  # the accept loop looks at ``stop`` twice a second
    if on_bound is not None:
        on_bound(srv.getsockname()[1])
    try:
        while stop is None or not stop.is_set():
            try:
                conn, _ = srv.accept()
            except TimeoutError:
                continue
            conn.settimeout(idle_timeout)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            try:
                conn.sendall(struct.pack("<I", len(hello)) + hello)
                while True:
                    cmd, payload = _recv_msg(conn)
                    if cmd == _CMD_RESET:
                        (seed,) = struct.unpack("<q", payload)
                        try:
                            obs = venv.reset(None if seed < 0 else int(seed))
                        except Exception as exc:
                            raise _EnvCrash(exc) from exc
                        out = codec.pack(obs)
                    elif cmd == _CMD_STEP:
                        # a payload that does not decode is the client's
                        # fault: it drops the connection below, the fleet
                        # and its episodes stay
                        act = np.frombuffer(payload, act_dtype).reshape(act_shape)
                        try:
                            res, carry = venv.step(act)
                        except Exception as exc:
                            raise _EnvCrash(exc) from exc
                        out = _pack_step(codec, res, carry)
                    elif cmd == _CMD_CLOSE:
                        break  # this connection only: the farm serves on
                    else:
                        raise ValueError(f"unknown command {cmd}")
                    conn.sendall(struct.pack("<I", len(out)) + out)
            except OSError:
                continue  # the learner went away (or idled out); keep the farm
            except _EnvCrash as exc:
                print(f"[farm] env failure ({exc!r}); rebuilding fleet", file=sys.stderr, flush=True)
                venv.close()
                venv = HostVectorEnv(env_fns)
                venv.reset()
            except (ValueError, struct.error) as exc:
                # a protocol violation: drop this connection, keep the fleet
                print(f"[farm] protocol error ({exc!r}); dropping connection", file=sys.stderr, flush=True)
            finally:
                conn.close()
    finally:
        srv.close()
        venv.close()


# -- the client ---------------------------------------------------------------


class _Farm:
    """One connection to one farm, with transparent reconnect."""

    def __init__(self, address: str, reconnect_timeout: float = 60.0, request_timeout: float = 120.0):
        host, port = address.rsplit(":", 1)
        self.address = (host, int(port))
        self.reconnect_timeout = reconnect_timeout
        self.request_timeout = request_timeout
        self.sock: socket.socket | None = None
        self._handshake(first=True)

    def _handshake(self, first: bool = False) -> None:
        sock = socket.create_connection(self.address, timeout=self.request_timeout)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            (ln,) = struct.unpack("<I", _recv_exact(sock, 4))
            hello = json.loads(_recv_exact(sock, ln).decode())
        except BaseException:
            sock.close()
            raise
        if hello.get("proto") != _PROTO:
            sock.close()
            raise FarmMismatchError(f"farm at {self.address} speaks protocol {hello.get('proto')!r}, "
                                    f"expected {_PROTO}")
        num_envs = int(hello["num_envs"])
        codec = _ObsCodec([(n, sh, dt) for n, sh, dt in hello["obs_fields"]], num_envs)
        if first:
            self.num_envs = num_envs
            self.codec = codec
            self.observation_space = _space_from_json(hello["observation_space"])
            self.action_space = _space_from_json(hello["action_space"])
        elif num_envs != self.num_envs or codec.fields != self.codec.fields:
            sock.close()
            raise FarmMismatchError(f"farm at {self.address} changed shape across reconnect "
                                    f"(num_envs {self.num_envs}->{num_envs}, fields {self.codec.fields}->"
                                    f"{codec.fields})")
        self.sock = sock

    def _request(self, cmd: int, payload: bytes) -> bytes:
        """One request and its reply; on a failed connection, reconnect and
        re-send until ``reconnect_timeout`` runs out (at-least-once)."""
        deadline = time.monotonic() + self.reconnect_timeout
        while True:
            try:
                if self.sock is None:
                    self._handshake()
                _send_msg(self.sock, cmd, payload)
                (ln,) = struct.unpack("<I", _recv_exact(self.sock, 4))
                return _recv_exact(self.sock, ln)
            except OSError as exc:
                if self.sock is not None:
                    self.sock.close()
                    self.sock = None
                if time.monotonic() > deadline:
                    raise ConnectionError(f"farm at {self.address} unreachable for "
                                          f"{self.reconnect_timeout:.0f}s: {exc}") from exc
                time.sleep(0.3)

    def reset(self, seed: int | None):
        obs, _ = self.codec.unpack(self._request(_CMD_RESET, struct.pack("<q", -1 if seed is None else seed)))
        return obs

    def step(self, actions: np.ndarray) -> tuple[HostStepResult, object]:
        buf = self._request(_CMD_STEP, np.ascontiguousarray(actions, _action_dtype(self.action_space)).tobytes())
        obs, off = self.codec.unpack(buf)
        n = self.num_envs
        rew = np.frombuffer(buf, np.float32, count=n, offset=off).copy()
        off += 4 * n
        term = np.frombuffer(buf, np.uint8, count=n, offset=off) > 0
        off += n
        trunc = np.frombuffer(buf, np.uint8, count=n, offset=off) > 0
        off += n
        carry, _ = self.codec.unpack(buf, off)
        return HostStepResult(obs, rew, term, trunc), carry

    def close(self) -> None:
        if self.sock is not None:
            try:
                _send_msg(self.sock, _CMD_CLOSE, b"")
            except OSError:
                pass
            self.sock.close()
            self.sock = None


def _cat_obs(items: list):
    if isinstance(items[0], dict):
        return {k: np.concatenate([it[k] for it in items]) for k in items[0]}
    return np.concatenate(items, axis=0)


class RemoteVectorEnv:
    """One or more farms driven as a single host vector env.

    ``addresses`` are ``"host:port"`` strings; the envs are each farm's,
    concatenated in address order.  Farms step concurrently (a thread
    pool), so a step costs the slowest farm's round trip.  A farm restart
    or a network blip is absorbed by that farm's reconnect
    (``reconnect_timeout`` seconds); ``request_timeout`` bounds each round
    trip.
    """

    is_host_env = True

    def __init__(self, addresses: Sequence[str], reconnect_timeout: float = 60.0, request_timeout: float = 120.0):
        self.farms: list[_Farm] = []
        try:
            for a in addresses:
                self.farms.append(_Farm(a, reconnect_timeout, request_timeout))
        except BaseException:
            for f in self.farms:
                f.close()
            raise
        self.num_envs = sum(f.num_envs for f in self.farms)
        self.observation_space = self.farms[0].observation_space
        self.action_space = self.farms[0].action_space
        self.pool = ThreadPoolExecutor(max_workers=len(self.farms))
        self._splits = np.cumsum([f.num_envs for f in self.farms])[:-1]

    def reset(self, seed: int | None = None):
        """Reset every farm, the envs of the farm at offset ``k`` with
        ``seed + k`` onwards."""
        seeds = [None if seed is None else seed + int(off) for off in [0, *self._splits]]
        return _cat_obs(list(self.pool.map(lambda fs: fs[0].reset(fs[1]), zip(self.farms, seeds))))

    def step(self, actions: np.ndarray) -> tuple[HostStepResult, object]:
        chunks = np.split(np.asarray(actions), self._splits, axis=0)
        outs = list(self.pool.map(lambda fa: fa[0].step(fa[1]), zip(self.farms, chunks)))
        results = [o[0] for o in outs]
        return (
            HostStepResult(
                _cat_obs([r.obs for r in results]),
                np.concatenate([r.reward for r in results]),
                np.concatenate([r.terminated for r in results]),
                np.concatenate([r.truncated for r in results]),
            ),
            _cat_obs([o[1] for o in outs]),
        )

    def close(self) -> None:
        for f in self.farms:
            f.close()
        self.pool.shutdown(wait=True)


def _main() -> None:
    import argparse
    import importlib

    p = argparse.ArgumentParser(description="Serve a remote env farm")
    p.add_argument("--env", required=True,
                   help="gymnasium env id, or 'module:factory' naming a zero-argument callable that returns an env")
    p.add_argument("--num-envs", type=int, default=8)
    p.add_argument("--port", type=int, default=0, help="0 binds a free port; the port bound is printed")
    p.add_argument("--host", default="0.0.0.0",
                   help="bind interface; farms are unauthenticated, prefer a private one")
    args = p.parse_args()

    if ":" in args.env:
        mod, fn = args.env.split(":", 1)
        make = getattr(importlib.import_module(mod), fn)
    else:
        import gymnasium as gym

        def make():
            return gym.make(args.env)

    serve_envs([make] * args.num_envs, port=args.port, host=args.host,
               on_bound=lambda port: print(f"[farm] serving {args.num_envs} envs on {args.host}:{port}", flush=True))


if __name__ == "__main__":
    _main()
