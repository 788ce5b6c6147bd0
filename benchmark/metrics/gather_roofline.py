"""``gather_rows_cast``'s share of its roofline, in %: the least time of the
traced launches over their measured device time.

A launch gathers ``updates * batch`` frame stacks of ``frames_stack`` rows
(``obs``; ``obs_next`` is a second launch of the same size).  Its bytes are
counted as ``chip_smoke._gather_bound`` counts them: the distinct rows read
once, every bfloat16 row written, the indices.  The distinct rows are the
expectation under uniform sampling of a full ring of ``R`` rows: each draw
covers ``span`` consecutive rows, so a row escapes all ``draws`` draws with
probability ``(1 - span / R) ** draws`` (:func:`expected_distinct`).
"""

from benchmark.roofline import gather_bound_s


def expected_distinct(rows: int, draws: int, span: int) -> float:
    """Expected distinct rows that ``draws`` uniform stacks of ``span``
    consecutive rows touch in a ring of ``rows``."""
    return rows * (1.0 - (1.0 - span / rows) ** draws)


def read(run):
    t = run.trace_result
    if not t or not t.get("gather_launches"):
        return None
    cfg, tr = run.config, run.traffic
    span = cfg.get("frames_stack", 1)
    draws = tr["updates"] * tr["batch"]
    feat = cfg["env"]["height"] * cfg["env"]["width"]
    distinct = expected_distinct(tr["num_envs"] * tr["capacity"], draws, span)
    bound, _ = gather_bound_s(feat, draws * span, distinct)
    return 100.0 * bound * t["gather_launches"] / t["gather_s"]
