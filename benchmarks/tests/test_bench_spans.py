"""The readers of the program's own marks (spans.py and the metrics that use
it) on hand-built traces: the captured tick's three stages cut by the marker
kernels, with the markers in and out of order; the device's idle time given
to the innermost program span, the profiler's own ranges left out; a trace
of a program without marks or spans reads as nothing."""

import pytest

import harness as H
import spans

RENDER = "void (anonymous namespace)::render_kernel<2, false>(Params)"


def tick_kernels(t0, sim=(1.0, 2.0), reset=(0.5,), cull=(0.25, 0.25), render=4.0,
                 marks=("tick", "reset", "cull")):
    """One tick's kernels back to back from t0 (durations in seconds, each
    marker 0.125 s): [(name, start, end)], and where it ends."""
    stages = dict(tick=sim, reset=reset, cull=cull)
    out, t = [], t0
    for m in marks:
        out.append((spans.MARK_PREFIX + m, t, t + 0.125))
        t += 0.125
        for i, d in enumerate(stages[m]):
            out.append((f"elementwise_{m}_{i}", t, t + d))
            t += d
    out.append((RENDER, t, t + render))
    return out, t + render


def trace(kernels, labels=(), window=None):
    window = window or (min(s for _, s, _ in kernels) - 1.0, max(e for _, _, e in kernels) + 1.0)
    return H.TraceSummary(kernels, {}, list(labels), window)


def two_ticks(**kw):
    a, t = tick_kernels(0.0, **kw)
    b, _ = tick_kernels(t + 0.5, **kw)
    # a copy outside the tick (the action row) is no stage's
    return a + [("Memcpy DtoD", t + 0.1, t + 0.2)] + b


def test_tick_stages_sum_the_kernels_between_the_markers():
    tr = trace(two_ticks())
    sums, ticks = spans.tick_stages(tr)
    assert ticks == 2 and sums == {"tick": 6.0, "reset": 1.0, "cull": 1.0}
    result = {"trace": tr, "trace_steps": 2}
    read = {n: H.load_metric(n).read(result) for n in
            ("sim_step_ms_per_step", "reset_ms_per_step", "cull_prologue_ms_per_step")}
    assert read == {"sim_step_ms_per_step": 3000.0, "reset_ms_per_step": 500.0,
                    "cull_prologue_ms_per_step": 500.0}
    # with sim_prologue_ms_per_step: the stages, the markers and the copy outside
    prologue = H.load_metric("sim_prologue_ms_per_step").read(result)
    assert prologue == pytest.approx(sum(read.values()) + 3 * 125.0 + 50.0)


@pytest.mark.parametrize("marks", [("tick", "cull", "reset"), ("reset", "tick", "cull"),
                                   ("tick", "reset"), ("tick", "tick", "reset", "cull")],
                         ids=["swapped", "reset_first", "no_cull", "tick_twice"])
def test_tick_stages_need_every_marker_in_order(marks):
    kernels, t = tick_kernels(0.0)
    bad = [(spans.MARK_PREFIX + m, t + 1 + i, t + 1.1 + i) for i, m in enumerate(marks)]
    bad.append((RENDER, t + 10, t + 11))
    tr = trace(kernels + bad)
    assert spans.tick_stages(tr) is None
    assert H.load_metric("reset_ms_per_step").read({"trace": tr, "trace_steps": 2}) is None


def test_stages_read_nothing_without_markers_or_with_too_few_ticks():
    kernels, _ = tick_kernels(0.0)
    plain = [k for k in kernels if not k[0].startswith(spans.MARK_PREFIX)]
    assert spans.stage_ms_per_step({"trace": trace(plain), "trace_steps": 1}, "tick") is None
    # an unclosed tick at the stretch's end, or fewer ticks than steps
    assert spans.tick_stages(trace(kernels[:-1])) is None
    assert spans.stage_ms_per_step({"trace": trace(kernels), "trace_steps": 2}, "tick") is None
    assert spans.stage_ms_per_step({}, "tick") is None


def iteration_trace():
    """A window 0-100 s: kernels busy 10-20, 30-35, 60-90; spans rollout
    (0-50) holding policy (5-25) and tick (28-40), update (55-95); a CUPTI
    buffer request (40-45) inside the rollout and a flush (96-98) outside
    any span."""
    kernels = [("k1", 10.0, 20.0), ("k2", 30.0, 35.0), ("k3", 60.0, 90.0), ("k3b", 62.0, 70.0)]
    labels = [(0.0, 50.0, "megaverse.rollout"), (5.0, 25.0, "megaverse.rollout.policy"),
              (28.0, 40.0, "megaverse.tick"), (55.0, 95.0, "megaverse.update"),
              (40.0, 45.0, "Activity Buffer Request"), (96.0, 98.0, "Buffer_Flush"),
              (1.0, 99.0, "bench.iteration"), (6.0, 7.0, "aten::addmm")]
    return H.TraceSummary(kernels, {}, labels, (0.0, 100.0))


def test_idle_goes_to_the_innermost_span_and_leaves_out_the_profiler():
    tr = iteration_trace()
    got = spans.idle_by_span(tr)
    assert got == pytest.approx({
        "megaverse.rollout": 5 + 3 + 5,              # 0-5, 25-28, 45-50
        "megaverse.rollout.policy": 5 + 5,           # 5-10, 20-25
        "megaverse.tick": 2 + 5,                     # 28-30, 35-40
        "megaverse.update": 5 + 5,                   # 55-60, 90-95
        spans.PROFILER: 5 + 2,                       # 40-45, 96-98
        spans.OUTSIDE: 5 + 1 + 2})                   # 50-55, 95-96, 98-100
    assert sum(got.values()) == pytest.approx(tr.window_s - tr.busy_s)


def test_idle_metrics_read_their_span_and_add_up_to_at_most_the_idle():
    tr = iteration_trace()
    result = {"trace": tr, "trace_iterations": 1}
    names = ["idle_ms_per_iteration." + p for p in ("policy", "sample", "tick", "update")]
    read = {n: H.load_metric(n).read(result) for n in names}
    # no sampling span in this trace: that metric reads nothing
    assert read == {names[0]: 10e3, names[1]: None, names[2]: 7e3, names[3]: 10e3}
    idle_ms = H.load_metric("device_idle_share.train").read(result) / 100 * tr.window_s * 1e3
    assert sum(v for v in read.values() if v is not None) <= idle_ms
    result["trace_iterations"] = 2
    assert H.load_metric(names[0]).read(result) == 5e3


def test_idle_metrics_read_nothing_from_a_program_without_spans():
    tr = iteration_trace()
    tr.labels = [lab for lab in tr.labels if not lab[2].startswith(spans.SPAN_PREFIX)]
    result = {"trace": tr, "trace_iterations": 1}
    for p in ("policy", "sample", "tick", "update"):
        assert H.load_metric("idle_ms_per_iteration." + p).read(result) is None
    assert spans.idle_by_span(tr) == pytest.approx({spans.OUTSIDE: 48.0, spans.PROFILER: 7.0})
    assert spans.idle_ms_per_iteration({"trace_iterations": 1}, "megaverse.tick") is None
