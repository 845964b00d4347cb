"""The port's spans and device markers on the CPU (megaverse_tpu_torch/utils/
logging.py `span`, ops/marks.py).

- With no profiler recording, a span adds its host seconds and a call to
  `tprof()` and never opens a `record_function` range.
- Under a CPU `torch.profiler` the spans appear in the trace by name, a
  child inside its parent by time.
- `VectorEnv.step_many`: one "megaverse.step_many" per chunk holding its
  chunk_steps "megaverse.tick"s; once envs finish, a "megaverse.refill" with
  its poll, wait, stack and upload inside.
- The learner: "megaverse.rollout" holding a policy, a sample and a tick span
  per step; one "megaverse.update" per update, with "megaverse.pmean" inside
  where the update is data-parallel (one gloo rank here).
- The marker kernels launch nothing on the CPU; the trainer's summary holds
  its spans and its per-update times without a synchronise of its own.

2 envs, Empty; episodes of 0.5 s (8 ticks) where a refill is wanted.
"""

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

import megaverse_tpu_torch.constants as C
from megaverse_tpu_torch import VectorEnv
from megaverse_tpu_torch.env import render_batch
from megaverse_tpu_torch.ops import marks
from megaverse_tpu_torch.ops import raycast_cuda as RC
from megaverse_tpu_torch.parallel.mesh import ParallelLearner
from megaverse_tpu_torch.rl import learner as TL
from megaverse_tpu_torch.rl import train
from megaverse_tpu_torch.scenarios import make_scenario
from megaverse_tpu_torch.types import scene_to_device, stack_scenes, state_from_scene
from megaverse_tpu_torch.utils import logging as TLOG

import torch_port_checks  # noqa: F401  (one intra-op torch thread)

B, A, T = 2, 1, 3


def spans_of(prof, prefix="megaverse."):
    """[(name, start us, end us)] of the program's spans in a finished trace."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.startswith(prefix)]


def inside(child, parent) -> bool:
    return parent[1] <= child[1] and child[2] <= parent[2]


def test_span_without_a_profiler_only_counts(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    before = TLOG.tprof().totals()
    for _ in range(3):
        with TLOG.span("megaverse.test.off"):
            sum(range(1000))
    (seconds, calls), = TLOG.tprof().totals(since=before).values()
    assert calls == 3 and seconds > 0
    assert "megaverse.test.off" in TLOG.tprof().summary()
    assert not hasattr(TLOG, "FpsCounter")


def test_spans_nest_in_a_cpu_profiler_trace():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with TLOG.span("megaverse.test.outer"):
            for _ in range(2):
                with TLOG.span("megaverse.test.inner"):
                    torch.ones(8).sum()
    got = spans_of(prof, "megaverse.test.")
    outer = [s for s in got if s[0] == "megaverse.test.outer"]
    inner = [s for s in got if s[0] == "megaverse.test.inner"]
    assert len(outer) == 1 and len(inner) == 2
    assert all(inside(s, outer[0]) for s in inner)
    # a span that raises still closes its range and counts
    before = TLOG.tprof().totals()
    with pytest.raises(ValueError):
        with TLOG.span("megaverse.test.raises"):
            raise ValueError
    assert [n for _, n in TLOG.tprof().totals(since=before).values()] == [1]


def test_step_many_holds_its_ticks_and_refills_hold_their_parts():
    # frames are not drawn: the spans are the same, the CPU ticks cheaper
    env = VectorEnv("Empty", num_envs=B, num_agents_per_env=A, seed=3, device="cpu",
                    params={C.P_EPISODE_LENGTH_SEC: 0.5}, render=False)
    pool = np.zeros((T, B, A), np.int32)
    try:
        env.reset()
        before = TLOG.tprof().totals()
        for _ in range(2):
            env.step_many(pool, T)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(2):      # the envs end at tick 8 (chunk 3), refilled after chunk 4
                env.step_many(pool, T)
        assert env.num_refills == 1
    finally:
        env.close()
    got = spans_of(prof)
    chunks = [s for s in got if s[0] == "megaverse.step_many"]
    ticks = [s for s in got if s[0] == "megaverse.tick"]
    assert len(chunks) == 2 and len(ticks) == 2 * T
    for c in chunks:
        assert sum(inside(t, c) for t in ticks) == T
    refills = [s for s in got if s[0] == "megaverse.refill"]
    assert len(refills) == 2 and not any(inside(r, c) for r in refills for c in chunks)
    for part in ("poll", "wait", "stack", "upload"):
        parts = [s for s in got if s[0] == f"megaverse.refill.{part}"]
        assert parts and all(any(inside(p, r) for r in refills) for p in parts), part
    counts = {k: n for k, (_, n) in TLOG.tprof().totals(since=before).items()}
    assert counts == {"megaverse.step_many": 4, "megaverse.tick": 4 * T, "megaverse.refill": 4,
                      "megaverse.refill.poll": 3, "megaverse.refill.wait": 1,
                      "megaverse.refill.stack": 1, "megaverse.refill.upload": 2}


def small_learner(rollout=T):
    scen = make_scenario("Empty", num_agents=A, params={C.P_EPISODE_LENGTH_SEC: 60.0})
    gens = [np.random.default_rng(i) for i in range(B)]
    first = scene_to_device(stack_scenes([scen.generate_checked(g) for g in gens]), "cpu")
    nxt = scene_to_device(stack_scenes([scen.generate_checked(g) for g in gens]), "cpu")
    state = state_from_scene(first, A, torch.arange(B, dtype=torch.int64))
    obs = render_batch(scen, state, fmt="packed")
    shaping = torch.from_numpy(np.tile(scen.shaping_array()[None], (B, 1, 1)))
    tl = TL.Learner(scen, B, TL.TrainConfig(rollout=rollout, hidden_size=16), device="cpu")
    return tl, tl.init(0, state, obs), nxt, shaping


def test_rollout_and_update_spans():
    tl, ls, nxt, shaping = small_learner()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ls, batch = tl.collect_rollout(ls, nxt, shaping)
        tl._update_from_batch(ls, batch)
    got = spans_of(prof)
    rollout = [s for s in got if s[0] == "megaverse.rollout"]
    update = [s for s in got if s[0] == "megaverse.update"]
    assert len(rollout) == 1 and len(update) == 1
    for name in ("megaverse.rollout.policy", "megaverse.rollout.sample", "megaverse.tick"):
        steps = [s for s in got if s[0] == name]
        assert len(steps) == T and all(inside(s, rollout[0]) for s in steps), name
    # per step: the policy, then the sampling, then the tick
    order = [s[0].rsplit(".", 1)[-1] for s in sorted(got, key=lambda s: s[1])
             if s[0] != "megaverse.rollout" and inside(s, rollout[0])]
    assert order == ["policy", "sample", "tick"] * T
    assert not inside(update[0], rollout[0])


def test_pmean_span_inside_the_update(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            world_size=1, rank=0)
    try:
        tl, ls, nxt, shaping = small_learner(rollout=2)
        runner = ParallelLearner(tl)
        ls = runner.init(0, ls.env_state, ls.obs)
        ls, batch = runner.collect_rollout(ls, nxt, shaping)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            runner._update_from_batch(ls, batch)
    finally:
        dist.destroy_process_group()
    got = spans_of(prof)
    update = [s for s in got if s[0] == "megaverse.update"]
    pmean = [s for s in got if s[0] == "megaverse.pmean"]
    assert len(update) == 1 and len(pmean) == 2     # the gradients, then the metrics
    assert all(inside(p, update[0]) for p in pmean)


def test_marks_launch_nothing_on_the_cpu(monkeypatch):
    def refuse():
        raise AssertionError("the marker library was loaded for a CPU tick")

    monkeypatch.setattr(marks, "load_library", refuse)
    launches = dict(RC.LAUNCHES)
    for name in marks.MARKS:
        marks.mark(name, torch.device("cpu"))
    with pytest.raises(KeyError):
        marks.mark("render", torch.device("cpu"))
    assert RC.LAUNCHES == launches
    source = (RC.CSRC_DIR / "marks.cu").read_text()
    assert all(f"__global__ void {marks.KERNEL_PREFIX}{n}()" in source for n in marks.MARKS)


def test_interval_timer_reads_host_ms_on_the_cpu():
    timer = TLOG.IntervalTimer("cpu")
    a = timer.stamp()
    b = timer.stamp()
    timer.add("x", a, b)
    timer.add("y", a, timer.stamp())
    ms = timer.read()
    assert list(ms) == ["x", "y"] and 0 <= ms["x"][0] <= ms["y"][0]
    assert timer.read() == ms and len(ms["x"]) == 1


def test_train_summary_holds_the_loop_spans(tmp_path):
    args = ["--env", "Empty", "--num_envs", str(B), "--num_agents_per_env", str(A),
            "--rollout", "2", "--hidden_size", "16", "--device", "cpu",
            "--train_dir", str(tmp_path), "--train_for_env_steps", str(3 * 2 * B)]
    assert train.main(args) == 0
    summary = json.loads((tmp_path / "default" / "train_summary.json").read_text())
    assert summary["updates"] == 3
    assert len(summary["rollout_ms"]) == len(summary["update_ms"]) == 3
    assert all(ms > 0 for ms in summary["rollout_ms"] + summary["update_ms"])
    spans = summary["spans"]
    assert spans["megaverse.rollout"]["calls"] == spans["megaverse.update"]["calls"] == 3
    assert spans["megaverse.refill"]["calls"] == 3
    assert spans["megaverse.tick"]["calls"] == spans["megaverse.rollout.policy"]["calls"] == 6
    assert all(v["seconds"] > 0 for v in spans.values())
