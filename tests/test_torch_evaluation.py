"""The port's evaluation layer and representation helpers
(tianshou_tpu_torch.evaluation and utils/repr, data/stats) against the JAX
package, on the CPU.

- ``iqm``, ``bootstrap_ci``, ``performance_profile`` and
  ``AggregatedResult`` equal the JAX package's exactly on the same numpy
  seed.
- Copies of ``tests/test_eval_plots.py`` (series alignment, the series
  read back through the port's tensorboard logger, the figures) and of
  ``tests/test_repr.py``, with the port's summaries of tensors: shape,
  dtype and device, never the values.  Where the port follows upstream
  Tianshou rather than the JAX package's copy (transient properties pickled
  as ``None``; cycles through plain containers), the test says so.
- ``SequenceSummaryStats`` and ``TimingStats`` equal the JAX package's.
- The launchers' failure tolerance.
"""

import dataclasses
import os
import pickle
from dataclasses import dataclass, field

import numpy as np
import pytest
import torch

from tianshou_tpu.data import stats as jstats
from tianshou_tpu.evaluation import aggregate as jagg
from tianshou_tpu_torch.data import stats as tstats
from tianshou_tpu_torch.evaluation import aggregate as tagg
from tianshou_tpu_torch.evaluation.launcher import JoblibExpLauncher, SequentialExpLauncher
from tianshou_tpu_torch.evaluation.plots import (
    align_series,
    load_test_return_series,
    plot_iqm_curves,
    plot_performance_profiles,
)
from tianshou_tpu_torch.utils.repr import DataclassPPrintMixin, ToStringMixin, getstate, setstate, to_string


# -- aggregation --------------------------------------------------------------
@pytest.mark.parametrize("shape", [(7,), (12, 3), (1,)])
def test_aggregation_equals_jax(shape):
    scores = np.random.default_rng(5).normal(10.0, 4.0, size=shape)
    assert tagg.iqm(scores) == jagg.iqm(scores)
    assert tagg.bootstrap_ci(scores, n_boot=300, seed=3) == jagg.bootstrap_ci(scores, n_boot=300, seed=3)
    taus = np.linspace(0, 20, 17)
    np.testing.assert_array_equal(tagg.performance_profile(scores, taus), jagg.performance_profile(scores, taus))
    t, j = tagg.AggregatedResult.from_scores(scores), jagg.AggregatedResult.from_scores(scores)
    np.testing.assert_array_equal(t.scores, j.scores)
    assert (t.iqm, t.ci_low, t.ci_high, t.mean, t.median) == (j.iqm, j.ci_low, j.ci_high, j.mean, j.median)


def test_iqm_properties():
    assert tagg.iqm(np.arange(100)) == pytest.approx(49.5, abs=1.0)
    x = np.asarray([1.0] * 10 + [1e9])  # robust to outliers
    assert tagg.iqm(x) == 1.0


# -- the figures (a copy of tests/test_eval_plots.py) ------------------------------
def test_align_series_interpolates_common_grid():
    s1 = [(0, 0.0), (10, 10.0), (20, 20.0)]
    s2 = [(5, 0.0), (15, 30.0), (25, 30.0)]
    steps, scores = align_series([s1, s2], num_points=3)
    np.testing.assert_allclose(steps, [5, 12.5, 20])
    np.testing.assert_allclose(scores[0], [5, 12.5, 20])
    np.testing.assert_allclose(scores[1], [0, 22.5, 30])


def test_load_series_roundtrip_through_logger(tmp_path):
    pytest.importorskip("tensorboard")
    from tianshou_tpu_torch.utils.logger import TensorboardLogger

    d = os.path.join(tmp_path, "run")
    logger = TensorboardLogger(d)
    for step, val in [(100, 1.0), (200, 3.0), (300, 5.0)]:
        logger.log_test_data({"returns_mean": val}, step)
    logger.finalize()
    assert load_test_return_series(d) == [(100, 1.0), (200, 3.0), (300, 5.0)]


def test_plot_outputs_are_written(tmp_path):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(0)
    steps = np.linspace(0, 1e6, 32)
    results = {
        "sac": (steps, rng.normal(10, 1, size=(5, 32)).cumsum(axis=1)),
        "ppo": (steps, rng.normal(8, 1, size=(5, 32)).cumsum(axis=1)),
    }
    p1 = plot_iqm_curves(results, os.path.join(tmp_path, "iqm.png"), title="t", n_boot=50)
    assert os.path.getsize(p1) > 1000
    finals = {k: v[1][:, -1] for k, v in results.items()}
    p2 = plot_performance_profiles(finals, os.path.join(tmp_path, "profile.png"))
    assert os.path.getsize(p2) > 1000


def test_plots_without_matplotlib_say_so(monkeypatch, tmp_path):
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        plot_performance_profiles({"a": np.ones(3)}, os.path.join(tmp_path, "p.png"))


# -- representations (a copy of tests/test_repr.py) -----------------------------
def test_to_string_summarizes_arrays_without_dumping():
    assert to_string(np.zeros((8, 4), np.float32)) == "f32[8,4]"
    assert to_string(np.uint8(3)) == "3"  # numpy scalars print values
    long = to_string(list(range(100)))
    assert "<92 more>" in long and "99" not in long


def test_to_string_summarizes_tensors_by_shape_dtype_and_device():
    assert to_string(torch.zeros((8, 4))) == "f32[8,4]@cpu"
    assert to_string(torch.zeros((2,), dtype=torch.bfloat16)) == "bf16[2]@cpu"
    assert to_string(torch.ones((), dtype=torch.int64)) == "i64[]@cpu"  # a 0-d tensor too: no value read


class _Cfg(ToStringMixin):
    def __init__(self):
        self.lr = 3e-4
        self.obs = np.zeros((64, 17), np.float32)
        self.weights = torch.zeros((3, 5), dtype=torch.uint8)
        self._private = "hidden"
        self.secret = "x"

    def _tostring_excludes(self):
        return ("secret",)


def test_tostring_mixin_excludes_and_summarizes():
    r = repr(_Cfg())
    assert r.startswith("_Cfg(") and "lr=0.0003" in r
    assert "f32[64,17]" in r and "u8[3,5]@cpu" in r
    assert "_private" not in r and "secret" not in r


def test_tostring_mixin_cycle_safe():
    class Node(ToStringMixin):
        def __init__(self):
            self.child = None

    a = Node()
    a.child = a
    assert "Node<...>" in repr(a)


def test_to_string_cycle_through_plain_containers():
    """Upstream behaviour: a list or dict that holds itself renders its
    cycle as ``<...>`` (the JAX package's copy recurses without end)."""
    loop: list = [1]
    loop.append(loop)
    assert to_string(loop) == "[1, <...>]"
    d: dict = {"a": 1}
    d["self"] = d
    assert to_string(d) == "{a=1, self=<...>}"


@dataclass
class _Stats(DataclassPPrintMixin):
    returns_mean: float = 1.0
    secret: int = 7
    nested: dict = field(default_factory=lambda: {"a": 1})


def test_pprint_asdict_excludes_fields():
    s = _Stats().pprints_asdict(exclude_fields=["secret"])
    assert s.startswith("_Stats") and "returns_mean" in s and "secret" not in s


class _V2:
    """Simulates loading a pickle written by an older class version."""

    def __init__(self):
        self.new_name = 1.0
        self.added = "default"
        self._cache = object()  # transient, not pickled

    def __getstate__(self):
        return getstate(_V2, self, transient_properties=["_cache"])

    def __setstate__(self, state):
        setstate(
            _V2,
            self,
            state,
            renamed_properties={"old_name": "new_name"},
            new_default_properties={"added": "default"},
            removed_properties=["gone"],
        )


def test_pickle_migration_roundtrip():
    obj = _V2()
    re = pickle.loads(pickle.dumps(obj))
    assert re.new_name == 1.0 and re.added == "default"
    # upstream behaviour: a transient property comes back as None, so that
    # a lazy ``if self._cache is None`` re-initialises it
    assert re._cache is None
    # an old version's state dict migrates
    stale = _V2.__new__(_V2)
    stale.__setstate__({"old_name": 5.0, "gone": 9})
    assert stale.new_name == 5.0 and stale.added == "default"
    assert not hasattr(stale, "gone") and not hasattr(stale, "old_name")


class _Slotted:
    __slots__ = ("a", "__dict__")

    def __init__(self):
        self.a = 1
        self.b = 2

    def __getstate__(self):
        return getstate(_Slotted, self)


def test_getstate_of_a_slotted_class():
    """Upstream behaviour: a superclass ``__getstate__`` that returns no
    mapping (slots) falls back to the instance dict."""
    assert _Slotted().__getstate__() == {"b": 2}


# -- stats -------------------------------------------------------------------------
def test_stats_dataclasses_equal_jax():
    seq = np.random.default_rng(1).normal(size=50)
    assert dataclasses.asdict(tstats.SequenceSummaryStats.from_sequence(seq)) == dataclasses.asdict(
        jstats.SequenceSummaryStats.from_sequence(seq))
    assert dataclasses.asdict(tstats.SequenceSummaryStats.from_sequence(torch.as_tensor(seq))) == pytest.approx(
        dataclasses.asdict(jstats.SequenceSummaryStats.from_sequence(seq)))
    assert tstats.SequenceSummaryStats.from_sequence([]) == tstats.SequenceSummaryStats(0.0, 0.0, 0.0, 0.0)
    assert [f.name for f in dataclasses.fields(tstats.TimingStats)] == [
        f.name for f in dataclasses.fields(jstats.TimingStats)]
    assert [f.name for f in dataclasses.fields(tstats.InfoStats)] == [
        f.name for f in dataclasses.fields(jstats.InfoStats)]
    info = tstats.InfoStats(1, 2, 3, 4.0, 0.5, 2.0)
    assert info.env_steps_per_sec == 1.0 and "gradient_step" in info.pprints_asdict()


# -- launchers -----------------------------------------------------------------------
class _Exp:
    def __init__(self, seed, fail=False):
        self.config = type("C", (), {"seed": seed})()
        self.fail = fail

    def run(self, name=None):
        if self.fail:
            raise RuntimeError(f"run {name} failed")
        return name


def test_launchers_tolerate_failures():
    exps = [_Exp(0), _Exp(1, fail=True), _Exp(2)]
    result = SequentialExpLauncher().launch(exps)
    assert result.successes == ["seed_0", "seed_2"]
    assert [i for i, _ in result.failures] == [1] and "run seed_1 failed" in result.failures[0][1]
    pytest.importorskip("joblib")
    result = JoblibExpLauncher(n_jobs=1, backend="sequential").launch(exps)
    assert result.successes == ["seed_0", "seed_2"] and [i for i, _ in result.failures] == [1]
