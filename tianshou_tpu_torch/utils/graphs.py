"""CUDA graphs of a step over carried state: the port's counterpart of the
JAX package's ``jax.jit`` plus ``.lower().compile()`` of the trainers' hot
steps (``OffPolicyTrainer._compile_superstep`` and ``_compile_host_step``,
``OnPolicyTrainer._compile_superstep`` and ``_compile_learn``,
``OfflineTrainer._compile_superstep``; the collection: the host
collectors' acting step, the fused fine cycle and the device
``Collector``'s segments; the distributed trainers' segments and
``make_distributed_update``).

A step ``fn(ts, cstate, bstate, generator, explore_param) -> (ts, cstate,
bstate, outputs, metrics)`` runs eagerly, one launch per operation.
:class:`CapturedStep` captures it once into a CUDA graph and then launches
that graph whole, so that a superstep costs one launch from the host.

The static-state protocol (:class:`StaticStep`, which also runs on the CPU,
eagerly):

- the train, collect and buffer states given at construction are the
  graph's static inputs, and every call takes and returns those same
  objects (a collect or buffer leaf that shares its storage with another,
  as views of one tensor do, is first given storage of its own,
  :func:`own_storage`);
- a leaf that the step writes in place (parameters, optimizer state, the
  ring, the sum tree) needs nothing more; a leaf that the step returns as a
  new tensor (the collect state, the cursors, the PER extrema) is copied
  back into the static one at the end of the step (inside the graph), so
  the next call reads it where the graph reads its inputs.  The ring is
  never copied.  Train-state leaves must be written in place: a step that
  rebinds one (``ts.x = new``) raises;
- a step whose input arrives from outside each call (the host paths'
  segment, an acting step's observation batch) reads it from a static
  staging tree carried as the collect state, which the caller writes in
  place before each call; a step with no buffer state carries ``None``;
- a step that fills one row of a preallocated ``[T, ...]`` output a call
  (an acting step's segment of actions) writes row ``cursor``, a 0-d int64
  tensor of its static state that the step advances (:func:`write_row`);
  the caller resets it with one fill a segment;
- anything that keeps a state across calls must clone it: the next call
  overwrites the static tensors, and the ``outputs`` and ``metrics`` a
  replay returns are the graph's own, overwritten by the next replay.  A
  clone of a parameter is taken detached (or under ``torch.no_grad()``):
  one that keeps an autograd edge to the parameter keeps its gradient
  accumulator, made on the caller's stream, alive into a later capture,
  which then fails.

Capture (the first call of each branch pattern, :meth:`CapturedStep._capture`):

1. every optimizer of the train state is made ready (not for a step that
   only acts, ``prepare_optimizers=False``, which leaves them as built)
   (:func:`prepare_optimizer`): the port's own Adam
   (:func:`mark_capturable`) is made capturable here, and only here, so
   that the paths that stay eager keep its cheaper host-side step count;
   any other optimizer must be capturable already (:func:`check_capturable`);
   its state is created (:func:`init_optimizer_state`): a state that an
   optimizer zeroes at its first step would be zeroed by every replay;
2. warm-up: the call runs ``fn`` eagerly on the static state, on the
   capture stream (one for the process, :func:`capture_stream`), as a
   real step whose results it returns, so that every operation's
   first-call set-up (a kernel library's build and its shared-memory
   limit, cuBLAS and cuDNN handles and workspaces) happens outside the
   capture.  Nothing is copied for it, the ring least of all;
3. capture on the static state, with Python's garbage collector paused
   (collecting a dead step's graph during a capture invalidates it) and the
   generators registered with the graph: each replay then draws from where the generators stand and
   advances them by the capture's draws, so that replays and eager draws
   between them (the test collector's) form one stream.  Capturing runs no
   work and draws nothing; the host ``step`` counters are put back to where
   the warm-up found them before it, so that the capture takes the
   warm-up's branches, and each replay advances them as the warm-up did.

Each warm-up and capture is a graph event of the tracer
(:mod:`~tianshou_tpu_torch.utils.trace`), recorded on or off, tagged with
the step's ``name`` and pattern key; ``graph.capture`` and
``graph.replay`` count them, and a graph's first replay is an event too.

The graphs are kept by ``key()``, the host-known pattern of the step's
branches (TD3's and REDQ's delayed actor step, from the host update count):
one graph per pattern a run meets, all in one memory pool.  A replay never
applies a graph captured for another pattern.

A step over ``torch.distributed`` process groups (the distributed trainers,
``make_distributed_update``) is captured with its collectives as nodes of
its graph, which the capture counts with their bytes
(``_Graph.collectives``: at world size 1 NCCL may launch no kernel, and the
count is then the evidence that they are there).  Only a step whose every
group is ``None`` or NCCL is captured (:func:`capturable_groups`): gloo
runs its collectives on the host and copies CUDA tensors through host
memory, which a stream capture cannot record, so :func:`compile_step`
keeps a step over a gloo group eager, on the card too.  That is a rule of
the group's backend, not a fall-back: a capture that fails raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from collections.abc import Callable, Hashable
from typing import Any

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from tianshou_tpu_torch.utils import trace

__all__ = ["CapturedStep", "StaticStep", "capturable_groups", "capture_stream", "check_capturable", "compile_step",
           "init_optimizer_state", "mark_capturable", "named_tensors", "optimizers", "own_storage",
           "prepare_optimizer", "step_counters", "write_row"]


def named_tensors(state: Any, prefix: str = "state") -> list[tuple[str, torch.Tensor]]:
    """The tensors of a carried state with their paths, in a fixed order:
    tensors; a module's parameters and buffers (its ``state_dict`` order);
    an optimizer's state tensors, parameter by parameter, keys sorted;
    dataclass fields; dict values; tuple and list items.  Generators and
    plain values are left out.  A module or tensor reached twice is listed
    twice."""
    out: list[tuple[str, torch.Tensor]] = []

    def walk(x: Any, path: str) -> None:
        if isinstance(x, torch.Tensor):
            out.append((path, x))
        elif isinstance(x, nn.Module):
            out.extend((f"{path}.{k}", v) for k, v in x.state_dict(keep_vars=True).items())
        elif isinstance(x, torch.optim.Optimizer):
            for i, p in enumerate(q for group in x.param_groups for q in group["params"]):
                st = x.state.get(p, {})
                out.extend((f"{path}.state[{i}].{k}", st[k]) for k in sorted(st) if isinstance(st[k], torch.Tensor))
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name), f"{path}.{f.name}")
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}[{k!r}]")
        elif isinstance(x, (tuple, list)):
            for i, v in enumerate(x):
                walk(v, f"{path}[{i}]")

    walk(state, prefix)
    return out


def write_row(out: torch.Tensor, cursor: torch.Tensor, row: torch.Tensor) -> None:
    """``out[cursor] = row`` with the row index on the device: ``cursor``
    is a 0-d int64 tensor, so that a graph writes the row its replay
    finds there."""
    out.index_copy_(0, cursor.view(1), row.unsqueeze(0))


def own_storage(x: Any, seen: set | None = None) -> Any:
    """``x`` with every tensor leaf whose storage an earlier leaf already
    holds (views of one tensor: CartPole's state fields) replaced by a copy,
    so that each leaf can take a copy of its own.  Dataclasses, dicts and
    lists change in place (``x`` keeps its identity); tuples are rebuilt
    where a leaf changed."""
    seen = set() if seen is None else seen
    if isinstance(x, torch.Tensor):
        ptr = x.untyped_storage().data_ptr()
        if x.numel() and ptr in seen:
            return x.clone()
        seen.add(ptr)
        return x
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            old = getattr(x, f.name)
            new = own_storage(old, seen)
            if new is not old:
                object.__setattr__(x, f.name, new)
    elif isinstance(x, (dict, list)):
        for k in list(x.keys()) if isinstance(x, dict) else range(len(x)):
            new = own_storage(x[k], seen)
            if new is not x[k]:
                x[k] = new
    elif isinstance(x, tuple):
        items = [own_storage(v, seen) for v in x]
        if any(a is not b for a, b in zip(items, x)):
            return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)
    return x


def _objects(state: Any, want: Callable[[Any], bool]) -> list:
    """The objects of ``state`` (through dataclass fields, tuples and lists)
    for which ``want`` holds, each once, in a fixed order."""
    found: list = []

    def walk(x: Any) -> None:
        if want(x) and all(x is not y for y in found):
            found.append(x)
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)

    walk(state)
    return found


def optimizers(ts: Any) -> list[torch.optim.Optimizer]:
    """Every optimizer of a train state."""
    return _objects(ts, lambda x: isinstance(x, torch.optim.Optimizer))


def step_counters(ts: Any) -> list:
    """The train state's dataclasses that count updates on the host (an
    ``int`` field ``step``)."""
    def counts(x):
        return (dataclasses.is_dataclass(x) and not isinstance(x, type)
                and any(f.name == "step" for f in dataclasses.fields(x)) and isinstance(x.step, int))

    return _objects(ts, counts)


def check_capturable(optimizer: torch.optim.Optimizer) -> None:
    """Raise ``ValueError`` unless every parameter group of ``optimizer`` is
    capturable: a non-capturable optimizer keeps its step count on the host,
    which a CUDA graph cannot advance."""
    bad = [i for i, group in enumerate(optimizer.param_groups) if not group.get("capturable", False)]
    if bad:
        raise ValueError(
            f"{type(optimizer).__name__} parameter group(s) {bad} are not capturable; the superstep on CUDA runs as "
            f"a CUDA graph: build the optimizer with capturable=True (e.g. torch.optim.Adam(params, lr, "
            f"capturable=True)), or use tianshou_tpu_torch.algos.ddpg.adam, which a capture makes capturable")


def mark_capturable(optimizer: torch.optim.Optimizer) -> torch.optim.Optimizer:
    """Mark a ``torch.optim.Adam`` or ``AdamW`` that a capture may make
    capturable (:func:`prepare_optimizer`); returns it.  The port marks its
    own Adam (:func:`~tianshou_tpu_torch.algos.ddpg.adam`); an optimizer a
    caller builds is used as built.  The mark is kept in the optimizer's
    ``defaults``, which a copy, a pickle or a restored checkpoint of it
    keeps: ``Optimizer.__getstate__`` drops any other attribute."""
    if not isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        raise TypeError(f"only Adam and AdamW are made capturable at capture, not {type(optimizer).__name__}")
    optimizer.defaults["capturable_at_capture"] = True
    return optimizer


def _step_dtype(p: torch.Tensor) -> torch.dtype:
    """A capturable Adam's step-count dtype for parameter ``p``: it computes
    its bias correction in that dtype, so a float64 parameter counts in
    float64 (PyTorch's own first step counts in float32)."""
    return torch.float64 if p.dtype == torch.float64 else _scalar_dtype()


def prepare_optimizer(optimizer: torch.optim.Optimizer) -> None:
    """Make ``optimizer`` ready for a CUDA graph: a marked one
    (:func:`mark_capturable`) becomes capturable, its step counts moved to
    its parameters' device; then :func:`check_capturable` and
    :func:`init_optimizer_state`."""
    if optimizer.defaults.get("capturable_at_capture", False):
        for group in optimizer.param_groups:
            if group["capturable"]:
                continue
            group["capturable"] = True
            for p in group["params"]:
                st = optimizer.state.get(p)
                if st and "step" in st:
                    st["step"] = st["step"].to(device=p.device, dtype=_step_dtype(p))
    check_capturable(optimizer)
    init_optimizer_state(optimizer)


def _scalar_dtype() -> torch.dtype:
    return torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32


def init_optimizer_state(optimizer: torch.optim.Optimizer) -> None:
    """Create ``optimizer``'s state for every parameter that has none, as its
    first step would: ``init_state()`` where the optimizer defines it, else
    Adam's (and AdamW's) zero moments and zero step (a capturable one's on
    the device, :func:`_step_dtype`).  Raises ``ValueError`` for another optimizer whose state is
    missing."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    if all(optimizer.state.get(p) for p in params):
        return
    init = getattr(optimizer, "init_state", None)
    if init is not None:
        init()
        return
    if not isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        raise ValueError(f"cannot create the state of a {type(optimizer).__name__} before its first step; the "
                         f"captured superstep supports Adam, AdamW and optimizers that define init_state()")
    for group in optimizer.param_groups:
        for p in group["params"]:
            if optimizer.state.get(p):
                continue
            if group.get("fused", False):
                step = torch.zeros((), dtype=torch.float32, device=p.device)
            elif group.get("capturable", False):
                step = torch.zeros((), dtype=_step_dtype(p), device=p.device)
            else:
                step = torch.tensor(0.0, dtype=_scalar_dtype())
            st = {"step": step,
                  "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                  "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format)}
            if group.get("amsgrad", False):
                st["max_exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            optimizer.state[p] = st


_CAPTURE_STREAMS: dict[torch.device, torch.cuda.Stream] = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream on which every warm-up and capture on ``device``
    runs, one for the process: cuBLAS and cuBLASLt keep a workspace for
    each stream that runs a matrix product (64 MiB together on an H100,
    held until the process ends), so a stream of its own for each compiled
    step would hold 64 MiB more for every trainer a process builds."""
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


def capturable_groups(*groups) -> bool:
    """Whether a step whose collectives run over ``groups`` may be captured
    into a CUDA graph: every group ``None`` (one process, no collective) or
    NCCL (module docstring: a gloo group keeps the step eager)."""
    import torch.distributed as dist

    return all(g is None or dist.get_backend(g) == "nccl" for g in groups)


class _Collectives(TorchDispatchMode):
    """While on, records each ``torch.distributed`` collective dispatched
    (the ``c10d`` operators, those the autograd engine runs in a backward
    pass included) as ``(operator, bytes of its first argument's
    tensors)``, and counts those issued while the current stream was not
    capturing (``off_capture``)."""

    def __init__(self):
        super().__init__()
        self.calls: list[tuple[str, int]] = []
        self.off_capture = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "c10d" and args:
            tensors = [t for t in tree_leaves(args[0]) if isinstance(t, torch.Tensor)]
            self.calls.append((func.__name__.split(".")[0], sum(t.numel() * t.element_size() for t in tensors)))
            self.off_capture += not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing())
        return func(*args, **(kwargs or {}))


def _generator_list(generator) -> list:
    """The generators of a step's ``generator`` argument: one, or each of a
    tuple or list."""
    return list(generator) if isinstance(generator, (tuple, list)) else [generator]


class StaticStep:
    """``fn`` under the static-state protocol (module docstring), run
    eagerly: each call runs ``fn`` on the static state, copies the returned
    leaves that are new tensors into the static ones and returns the static
    state with ``fn``'s ``outputs`` and ``metrics``."""

    def __init__(self, fn: Callable, ts: Any, cstate: Any, bstate: Any):
        self.fn = fn
        seen: set = set()
        self.ts, self.cstate, self.bstate = ts, own_storage(cstate, seen), own_storage(bstate, seen)
        #: bytes the last step copied back into the static state
        self.copy_back_bytes = 0

    @property
    def states(self) -> tuple:
        return self.ts, self.cstate, self.bstate

    def _check_static(self, ts: Any, cstate: Any, bstate: Any) -> None:
        if ts is not self.ts or cstate is not self.cstate or bstate is not self.bstate:
            raise ValueError("a captured step takes the state that the previous call returned (its static state); "
                             "for another state, compile the step again over it")

    def write_back(self, ts: Any, cstate: Any, bstate: Any) -> int:
        """Copy the leaves of a returned state that are not the static
        tensors into them (one multi-tensor copy); returns the bytes
        copied.  Raises where the structure, a shape or a dtype differs, or
        where a train-state leaf was replaced instead of written in place."""
        static, out = named_tensors(self.states), named_tensors((ts, cstate, bstate))
        if [n for n, _ in static] != [n for n, _ in out]:
            raise ValueError(f"the step changed the carried state's structure: "
                             f"{sorted(set(n for n, _ in static) ^ set(n for n, _ in out))}")
        dst, src = [], []
        for (name, s), (_, o) in zip(static, out):
            if o is s:
                continue
            if name.startswith("state[0]"):
                raise RuntimeError(f"the step replaced the train-state tensor {name} instead of writing it in place")
            if o.shape != s.shape or o.dtype != s.dtype:
                raise ValueError(f"the step returns {name} as {o.dtype}{list(o.shape)}, carried as "
                                 f"{s.dtype}{list(s.shape)}")
            dst.append(s)
            src.append(o)
        # a source that shares storage with a destination is read before any
        # destination is written
        written = {d.untyped_storage().data_ptr() for d in dst}
        src = [o.clone() if o.untyped_storage().data_ptr() in written else o for o in src]
        if len({d.untyped_storage().data_ptr() for d in dst}) != len(dst):
            raise ValueError("two carried leaves share storage and the step returns them apart")
        if dst:
            with torch.no_grad():
                torch._foreach_copy_(dst, src)
        return sum(d.numel() * d.element_size() for d in dst)

    def run_fn(self, generator, explore_param) -> tuple:
        """``fn`` on the static state, its new leaves copied back:
        ``(outputs, metrics)``.  Raises where ``fn`` rebound a train-state
        tensor (``ts.x = new``) instead of writing it in place: the static
        train state would then hold a tensor that a graph does not write."""
        before = dict(named_tensors(self.ts))
        ts, cstate, bstate, outputs, metrics = self.fn(*self.states, generator, explore_param)
        rebound = [n for n, t in named_tensors(self.ts) if n in before and before[n] is not t]
        if rebound:
            raise RuntimeError(f"the step rebound the train-state tensors {rebound} instead of writing them in place")
        self.copy_back_bytes = self.write_back(ts, cstate, bstate)
        return outputs, metrics

    def __call__(self, ts, cstate, bstate, generator, explore_param):
        self._check_static(ts, cstate, bstate)
        return (*self.states, *self.run_fn(generator, explore_param))


@dataclasses.dataclass
class _Graph:
    graph: Any
    outputs: Any
    metrics: Any
    steps: list  # (counter, updates a replay)
    replays: int = 0
    #: the collectives the capture recorded, ``(operator, bytes)`` each
    #: (counted for a step over process groups only)
    collectives: list = dataclasses.field(default_factory=list)
    #: ``<step name>:<pattern key>``, the graph's tag in the tracer
    tag: str = ""


class CapturedStep(StaticStep):
    """``fn`` captured into CUDA graphs and replayed (module docstring).
    ``key()`` names the branch pattern of the next call (``()`` for a step
    without host-keyed branches).  The first call of a pattern runs ``fn``
    eagerly as the warm-up and captures its graph; later calls of the
    pattern replay it.  ``explore_param`` is copied into a static 0-d
    float32 tensor, which the graph reads (a caller that passes that tensor,
    written once for many calls, saves the copy).  ``prepare_optimizers``
    False leaves the train state's optimizers as built: a step that only
    acts steps none.  ``generator`` may be one generator or a tuple of them,
    each registered with the graphs.  ``groups``: the process groups of the
    step's collectives, which each capture then counts
    (``_Graph.collectives``); every one must be ``None`` or NCCL.
    ``name`` (``offpolicy.superstep``, ``collect.episodes``) tags the step's
    spans, graph events and counters in
    :mod:`~tianshou_tpu_torch.utils.trace`: ``graph.capture`` and
    ``graph.replay`` per name and pattern key."""

    def __init__(self, fn: Callable, ts: Any, cstate: Any, bstate: Any, key: Callable[[], Hashable] = tuple,
                 prepare_optimizers: bool = True, groups: tuple = (), name: str = "step"):
        super().__init__(fn, ts, cstate, bstate)
        self.name = name
        if not capturable_groups(*groups):
            raise ValueError("a step over a gloo process group cannot be captured: its collectives run on the host")
        self.prepare_optimizers = prepare_optimizers
        self.count_collectives = any(g is not None for g in groups)
        leaves = named_tensors(self.states)
        self.device = leaves[0][1].device
        if self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA state, not {self.device}")
        self.key = key
        self.explore = torch.zeros((), dtype=torch.float32, device=self.device)
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = capture_stream(self.device)
        self.graphs: dict[Hashable, _Graph] = {}
        self.generator: torch.Generator | tuple | None = None
        #: seconds spent in warm-up steps, and in captures (instantiation
        #: included)
        self.warm_up_s = 0.0
        self.capture_s = 0.0

    def _generators(self) -> list[torch.Generator]:
        gens = [*_generator_list(self.generator), getattr(self.cstate, "rng", None)]
        return [g for i, g in enumerate(gens) if isinstance(g, torch.Generator) and all(g is not h for h in gens[:i])]

    def _capture(self, key: Hashable) -> tuple:
        """The first call of pattern ``key``: the warm-up step, then the
        capture (module docstring); returns the warm-up's results.  The two
        are the spans ``tianshou.graph.warm_up`` and
        ``tianshou.graph.capture`` and the graph events ``graph.warm_up``
        and ``graph.capture``, tagged ``<name>:<key>``
        (:mod:`~tianshou_tpu_torch.utils.trace`)."""
        tag = f"{self.name}:{key!r}"
        t0 = time.perf_counter_ns()
        with trace.span("tianshou.graph.warm_up", tag):
            for opt in optimizers(self.ts) if self.prepare_optimizers else ():
                prepare_optimizer(opt)
            counters = step_counters(self.ts)
            before = [c.step for c in counters]
            current = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                outputs, metrics = self.run_fn(self.generator, self.explore)
            current.wait_stream(self.stream)
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter_ns()
        with trace.span("tianshou.graph.capture", tag):
            self.graphs[key] = self._capture_graph(counters, before, tag)
        t2 = time.perf_counter_ns()
        trace.note("graph.warm_up", tag, t0, t1)
        trace.note("graph.capture", tag, t1, t2)
        trace.count("graph.capture", tag)
        self.warm_up_s += (t1 - t0) / 1e9
        self.capture_s += (t2 - t1) / 1e9
        return outputs, metrics

    def _capture_graph(self, counters: list, before: list[int], tag: str) -> _Graph:
        """The capture of the pattern whose warm-up just ran (``before``:
        the host ``step`` counters before the warm-up)."""
        after = [c.step for c in counters]
        for c, s in zip(counters, before):
            c.step = s
        graph = torch.cuda.CUDAGraph()
        for g in self._generators():
            graph.register_generator_state(g)
        # a garbage collection inside the capture could destroy another
        # step's graph (a collector's compiled steps sit in reference
        # cycles), which invalidates the capture
        gc_was_enabled = gc.isenabled()
        gc.disable()
        counting = _Collectives() if self.count_collectives else contextlib.nullcontext()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream), counting:
                g_outputs, g_metrics = self.run_fn(self.generator, self.explore)
        finally:
            if gc_was_enabled:
                gc.enable()
        if [c.step for c in counters] != after:
            raise RuntimeError(f"the capture counted {[c.step for c in counters]} updates, its warm-up {after}")
        if getattr(counting, "off_capture", 0):
            raise RuntimeError(f"{counting.off_capture} collective(s) of the step were issued on a stream that was not "
                               f"capturing: the graph would replay without them")
        return _Graph(graph, g_outputs, g_metrics, [(c, a - b) for c, a, b in zip(counters, after, before)],
                      collectives=getattr(counting, "calls", []), tag=tag)

    def __call__(self, ts, cstate, bstate, generator, explore_param):
        self._check_static(ts, cstate, bstate)
        if self.generator is None:
            self.generator = generator
        elif len(given := _generator_list(generator)) != len(mine := _generator_list(self.generator)) or any(
                a is not b for a, b in zip(given, mine)):
            raise ValueError("every call of a captured step draws from the generators of its first call")
        if explore_param is not self.explore:
            if isinstance(explore_param, torch.Tensor):
                self.explore.copy_(explore_param)
            else:
                self.explore.fill_(float(explore_param))
        key = self.key()
        entry = self.graphs.get(key)
        if entry is None:
            return (*self.states, *self._capture(key))
        entry.graph.replay()
        if not entry.replays:
            trace.note("graph.first_replay", entry.tag)
        entry.replays += 1
        trace.count("graph.replay", entry.tag)
        for counter, n in entry.steps:
            counter.step += n
        return (*self.states, entry.outputs, entry.metrics)


def compile_step(fn: Callable, device: torch.device, ts: Any, cstate: Any, bstate: Any,
                 key: Callable[[], Hashable] = tuple, prepare_optimizers: bool = True, groups: tuple = (),
                 name: str = "step") -> Callable:
    """A compiled step: on CUDA a :class:`CapturedStep` over ``fn`` with
    ``ts``, ``cstate`` and ``bstate`` as its static state; on another
    device, which the caller asked for, ``fn`` itself, run eagerly: CUDA
    graphs exist only on CUDA.  ``groups``: the process groups whose
    collectives ``fn`` issues; where one of them is not NCCL (gloo),
    ``fn`` itself as well (:func:`capturable_groups`).  ``name``: the
    captured step's name in the tracer (:class:`CapturedStep`)."""
    if device.type != "cuda" or not capturable_groups(*groups):
        return fn
    return CapturedStep(fn, ts, cstate, bstate, key=key, prepare_optimizers=prepare_optimizers, groups=groups,
                        name=name)
