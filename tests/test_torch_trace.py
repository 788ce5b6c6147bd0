"""The port's in-program tracer (tianshou_tpu_torch/utils/trace.py) and
its spans, counters and graph events in OffPolicyTrainer.run():

- tracing off: ``span()`` is the shared no-op and records nothing;
- spans nest with their parents and superstep ids, ``set`` adds data, the
  buffer is bounded with a ``dropped`` count, counters and graph events;
- a 2-epoch CPU ``run()`` with tracing on records set-up, the superstep's
  children and the test phase in order, every superstep inside
  ``tianshou.run``; an on-policy ``run()`` records the same epoch loop's
  spans (no set-up spans, no ``.param``);
- under ``torch.profiler`` a span is a ``record_function`` range on the
  profiler's clock (the in-memory interval plus ``profiler_offset_ns``);
- repeated intervals (``trace.interval`` under ``trace.marking``) summed
  over the latest pass, on stand-in events; the updates of a prioritized
  CPU run drawing one by one, those of a uniform one from one presample;
- ``trace.enable(ranges=False)``: spans kept, no profiler range;
- on a card only (skipped here; ``python3 -m pytest --noconftest -q
  tests/test_torch_trace.py -m cuda`` there): the device marks of the
  captured superstep, the ``graph.capture`` / ``graph.replay`` counters
  and graph events of a run, and the graph's event-record nodes, none
  with tracing off; the same of a prioritized run, whose superstep
  records four nodes an update more and the data ``per_sample_ms`` and
  ``per_write_back_ms``.
"""

import ctypes

import pytest
import torch

from tianshou_tpu_torch.algos.dqn import DQN
from tianshou_tpu_torch.collect.collector import Collector
from tianshou_tpu_torch.data.buffer import ReplayBuffer
from tianshou_tpu_torch.data.prio import PrioritizedReplayBuffer
from tianshou_tpu_torch.envs.base import VectorEnv
from tianshou_tpu_torch.envs.classic import CartPole
from tianshou_tpu_torch.networks.common import QNet
from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer
from tianshou_tpu_torch.trainer.onpolicy import OnPolicyTrainer
from tianshou_tpu_torch.utils import trace

SUPERSTEP_CHILDREN = ["tianshou.superstep.param", "tianshou.superstep.launch", "tianshou.superstep.host_read",
                      "tianshou.superstep.summarize", "tianshou.superstep.log"]


@pytest.fixture
def tracing():
    """Tracing on over a clean record; off and cleared afterwards."""
    trace.clear()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.clear()


def _trainer(device: str, prioritized: bool = False, **kw) -> OffPolicyTrainer:
    env = CartPole()
    algo = DQN(QNet(4, (32,), 2), env.action_space, target_update_freq=50, device=device)
    buffer = (PrioritizedReplayBuffer if prioritized else ReplayBuffer)(capacity=200, num_envs=4)
    args = dict(max_epoch=2, step_per_epoch=64, step_per_collect=32, update_per_step=0.0625, batch_size=16,
                episode_per_test=2, warmup_steps=32, seed=0, train_param_fn=lambda e, s: 0.5)
    return OffPolicyTrainer(algo, Collector(algo, VectorEnv(env, 4, device=device), buffer, device=device),
                            Collector(algo, VectorEnv(env, 2, device=device), device=device), buffer,
                            device=device, **{**args, **kw})


def test_disabled_span_records_nothing():
    trace.clear()
    assert not trace.enabled()
    a, b = trace.span("tianshou.a"), trace.span("tianshou.b", tag="x")
    assert a is b
    with a as s:
        s.set(x_ms=1.0)
    assert trace.spans() == [] and trace.dropped() == 0
    assert trace.device_marks(torch.device("cpu")) is None


class _StandInEvent:
    """A CUDA event's stand-in on the CPU: ``record`` reads a shared clock
    that each record moves on by one millisecond."""

    clock = [0.0]

    def __init__(self):
        self.t = None

    def record(self):
        self.clock[0] += 1.0
        self.t = self.clock[0]

    def elapsed_time(self, other):
        return other.t - self.t


def test_intervals_sum_over_the_latest_pass(monkeypatch):
    monkeypatch.setattr(trace.DeviceMarks, "_event", staticmethod(_StandInEvent))
    assert trace.interval("per_sample") is trace.span("tianshou.off")  # no marks active: the no-op
    marks = trace.DeviceMarks()
    for updates in (3, 2):  # two passes through a step's Python, the second shorter
        marks.record("start")
        with trace.marking(marks):
            for _ in range(updates):
                with trace.interval("per_sample"):
                    _StandInEvent.clock[0] += 5.0
                with trace.interval("per_write_back"):
                    pass
        with trace.marking(None):
            with trace.interval("per_sample"):
                pass
        marks.record("updates")
    assert trace.interval("per_sample") is trace.span("tianshou.off")
    out = marks.read()
    # the second pass: two draws of 6 ms and two write-backs of 1 ms, each
    # interval its own pair of events; the plain marks as before (an
    # update's four records and its 5 ms, the last record's 1 ms)
    assert out["per_sample_ms"] == 12.0 and out["per_write_back_ms"] == 2.0
    assert out["updates_ms"] == 2 * (4 + 5.0) + 1.0 and len(marks._pairs["per_sample"]) == 3


@pytest.mark.parametrize("prioritized", [False, True])
def test_prioritized_updates_draw_one_by_one(prioritized, monkeypatch):
    sizes = []
    presample = DQN.presample

    def counted(self, buffer, bstate, generator, batch_size):
        sizes.append(batch_size)
        return presample(self, buffer, bstate, generator, batch_size)

    monkeypatch.setattr(DQN, "presample", counted)
    _trainer("cpu", prioritized, max_epoch=1).run()
    # two supersteps of two updates of 16: a draw an update, or one of 32
    assert sizes == ([16] * 4 if prioritized else [32] * 2)


def test_nesting_parents_supersteps_and_counters(tracing):
    trace.set_superstep(3)
    with trace.span("tianshou.outer") as outer:
        with trace.span("tianshou.inner", tag="t"):
            pass
        outer.set(a_ms=1.5)
        outer.set(b_ms=2.0)
        trace.set_superstep(4)
        with trace.span("tianshou.inner2"):
            pass
    with trace.span("tianshou.after"):
        pass
    s = trace.spans()
    assert [x.name for x in s] == ["tianshou.outer", "tianshou.inner", "tianshou.inner2", "tianshou.after"]
    assert [x.parent for x in s] == [-1, 0, 0, -1]
    assert [x.superstep for x in s] == [3, 3, 4, 4]
    assert s[1].tag == "t" and s[0].tag is None
    assert s[0].data == {"a_ms": 1.5, "b_ms": 2.0} and s[1].data is None
    assert all(x.start_ns <= x.end_ns for x in s)
    assert s[0].start_ns <= s[1].start_ns <= s[1].end_ns <= s[2].start_ns <= s[2].end_ns <= s[0].end_ns
    assert s[0].end_ns <= s[3].start_ns
    for _ in range(3):
        trace.count("graph.replay", "a:()")
    trace.count("graph.capture", "a:()")
    assert trace.counters() == {("graph.replay", "a:()"): 3, ("graph.capture", "a:()"): 1}
    trace.note("graph.capture", "a:()", 10, 20)
    trace.note("graph.first_replay", "a:()")
    ev = trace.events()
    assert [(e.name, e.tag) for e in ev] == [("graph.capture", "a:()"), ("graph.first_replay", "a:()")]
    assert (ev[0].start_ns, ev[0].end_ns) == (10, 20) and ev[1].start_ns == ev[1].end_ns > 20


def test_counters_and_graph_events_stay_on_when_tracing_is_off():
    trace.clear()
    try:
        trace.count("graph.capture", "a:()")
        trace.note("graph.warm_up", "a:()", 1, 2)
        assert trace.counters() == {("graph.capture", "a:()"): 1} and len(trace.events()) == 1
        assert trace.spans() == []
    finally:
        trace.clear()


def test_buffer_is_bounded(tracing, monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 3)
    with trace.span("tianshou.a"):
        for _ in range(4):
            with trace.span("tianshou.b"):
                with trace.span("tianshou.c"):
                    pass
    for _ in range(5):
        trace.note("graph.replay", "x")
    assert [x.name for x in trace.spans()] == ["tianshou.a", "tianshou.b", "tianshou.c"]
    assert len(trace.events()) == 3
    assert trace.dropped() == 6 + 2
    # the thread's stack of open spans is empty again
    monkeypatch.setattr(trace, "CAPACITY", 4)
    with trace.span("tianshou.d"):
        pass
    assert trace.spans()[-1].parent == -1


def _onpolicy_trainer(device: str) -> OnPolicyTrainer:
    from tianshou_tpu_torch.algos.ppo import PPO
    from tianshou_tpu_torch.networks.continuous import ValueNet

    env = CartPole()
    algo = PPO(QNet(4, (32,), 2), ValueNet(4, (32,)), env.action_space, device=device)
    return OnPolicyTrainer(algo, Collector(algo, VectorEnv(env, 4, device=device), device=device),
                           Collector(algo, VectorEnv(env, 2, device=device), device=device), max_epoch=2,
                           step_per_epoch=64, step_per_collect=32, batch_size=16, episode_per_test=2, seed=0,
                           device=device)


# per run: its trainer, the spans before the first superstep (the first the
# run's outermost), the superstep's children, the env steps that are no
# superstep's (the off-policy ring fill)
RUNS = {
    "offpolicy": (_trainer, ["tianshou.run", "tianshou.setup.init", "tianshou.setup.ring_fill"], SUPERSTEP_CHILDREN,
                  32),
    "onpolicy": (_onpolicy_trainer, [], SUPERSTEP_CHILDREN[1:], 0),
}


@pytest.mark.parametrize("kind", list(RUNS))
def test_offpolicy_run_records_its_spans_in_order(tracing, kind):
    build, setup, children, unstepped = RUNS[kind]
    info = build("cpu").run()
    s = trace.spans()
    names = [x.name for x in s]
    assert names[:len(setup)] == setup
    top_parent = 0 if setup else -1  # inside tianshou.run, or outermost
    supersteps = [x for x in s if x.name == "tianshou.superstep"]
    assert len(supersteps) == (info.env_step - unstepped) // 32
    assert [x.superstep for x in supersteps] == list(range(1, len(supersteps) + 1))
    for sup in supersteps:
        if setup:
            assert s[0].start_ns <= sup.start_ns <= sup.end_ns <= s[0].end_ns
        at = s.index(sup)
        assert sup.parent == top_parent
        kids = [x for x in s if x.parent == at]
        assert [x.name for x in kids] == children
        assert all(x.superstep == sup.superstep for x in kids)
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
        assert sup.data is None  # no device marks on the CPU
    for x in s:
        if x.name.startswith("tianshou.setup."):
            assert x.parent == 0 and x.end_ns <= supersteps[0].start_ns
    top = [x.name for x in s if x.parent == top_parent]
    epoch = ["tianshou.superstep"] * 2 + ["tianshou.epoch_end", "tianshou.test_phase"]
    assert top == setup[1:] + epoch * 2
    for at, x in enumerate(s):
        if x.name == "tianshou.test_phase":
            kids = [y.name for y in s if y.parent == at]
            assert kids[0] == "tianshou.test.reset" and len(kids) >= 2
            assert set(kids[1:]) == {"tianshou.test.chunk"}
    # on the CPU the steps run eagerly: nothing captured
    assert trace.counters() == {} and trace.events() == []


def test_span_under_the_profiler_shares_its_clock(tracing):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("tianshou.first"):
            pass
        with trace.span("tianshou.clock"):
            torch.ones(64).sum()
    rec = [x for x in trace.spans() if x.name == "tianshou.clock"][0]
    [event] = [e for e in prof.profiler.kineto_results.events() if e.name() == "tianshou.clock"]
    offset = trace.profiler_offset_ns()
    assert offset is not None
    assert abs(event.start_ns() - (rec.start_ns + offset)) < 100_000
    assert abs(event.end_ns() - (rec.end_ns + offset)) < 100_000
    # no profiler: no range, no offset change
    with trace.span("tianshou.unprofiled"):
        pass
    assert trace.profiler_offset_ns() == offset


def test_span_kept_out_of_the_profiler(tracing):
    from torch.profiler import ProfilerActivity, profile

    trace.enable(ranges=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("tianshou.quiet"):
            torch.ones(64).sum()
    assert [x.name for x in trace.spans()] == ["tianshou.quiet"]
    assert not [e for e in prof.profiler.kineto_results.events() if e.name().startswith("tianshou.")]
    assert trace.profiler_offset_ns() is None
    trace.enable()


# -- on a card only ----------------------------------------------------------------
def _event_record_nodes(graph: torch.cuda.CUDAGraph) -> tuple[int, int]:
    """``(nodes, event-record nodes)`` of a graph captured with
    ``keep_graph=True``, through libcuda's graph API."""
    cuda = ctypes.CDLL("libcuda.so.1")
    g = ctypes.c_void_p(int(graph.raw_cuda_graph()))
    n = ctypes.c_size_t(0)
    assert cuda.cuGraphGetNodes(g, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cuda.cuGraphGetNodes(g, nodes, ctypes.byref(n)) == 0
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0
        kinds.append(kind.value)
    return len(kinds), kinds.count(7)  # CU_GRAPH_NODE_TYPE_EVENT_RECORD


@pytest.mark.cuda
def test_device_marks_counters_and_event_nodes_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("device marks are CUDA events inside a CUDA graph (run on the card)")
    real = torch.cuda.CUDAGraph
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: real(keep_graph=True))
    counts = {}
    for on in (False, True):
        trace.clear()
        if on:
            trace.enable()
        try:
            trainer = _trainer("cuda")
            info = trainer.run()
        finally:
            trace.disable()
        [entry] = trainer.compiled_superstep.graphs.values()
        counts[on] = _event_record_nodes(entry.graph)
        tag = entry.tag
        assert tag.startswith("offpolicy.superstep:")
        supersteps = info.env_step // 32 - 1
        c = trace.counters()
        assert c[("graph.capture", tag)] == 1 and c[("graph.replay", tag)] == supersteps - 1
        fill = [t for (name, t) in c if name == "graph.capture" and t.startswith("collect.collect:")]
        assert len(fill) == 1 and ("graph.replay", fill[0]) not in c
        events = trace.events()
        assert [e.name for e in events if e.tag == tag] == ["graph.warm_up", "graph.capture", "graph.first_replay"]
        if not on:
            assert trainer.superstep_marks is None and trace.spans() == []
            continue
        s = trace.spans()
        data = [x.data for x in s if x.name == "tianshou.superstep"]
        assert len(data) == supersteps
        for d in data:
            assert set(d) == {"rollout_ms", "presample_ms", "updates_ms"} and all(v > 0 for v in d.values()), d
        assert [x.tag for x in s if x.name == "tianshou.graph.capture"].count(tag) == 1
    print(f"superstep graph nodes (all, event-record): tracing off {counts[False]}, on {counts[True]}")
    assert counts[False][1] == 0 and counts[True] == (counts[False][0] + 4, 4)
    trace.clear()


@pytest.mark.cuda
def test_per_update_intervals_and_event_nodes_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("device marks are CUDA events inside a CUDA graph (run on the card)")
    real = torch.cuda.CUDAGraph
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: real(keep_graph=True))
    counts = {}
    for on in (False, True):
        trace.clear()
        if on:
            trace.enable()
        try:
            trainer = _trainer("cuda", prioritized=True)
            trainer.run()
        finally:
            trace.disable()
        [entry] = trainer.compiled_superstep.graphs.values()
        counts[on] = _event_record_nodes(entry.graph)
        if on:
            data = [x.data for x in trace.spans() if x.name == "tianshou.superstep"]
            for d in data:
                assert set(d) == {"rollout_ms", "updates_ms", "per_sample_ms", "per_write_back_ms"}, d
                assert all(v > 0 for v in d.values()) and d["per_sample_ms"] + d["per_write_back_ms"] < d["updates_ms"]
    k = trainer.updates_per_segment
    print(f"prioritized superstep graph nodes (all, event-record): tracing off {counts[False]}, on {counts[True]}")
    assert counts[False][1] == 0 and counts[True] == (counts[False][0] + 3 + 4 * k, 3 + 4 * k)
    trace.clear()
