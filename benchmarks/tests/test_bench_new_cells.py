"""The cell `appo.towerbuilding_256x4` and the waiting cell
`sampler.empty_4096x1` (its traffic file is ready, its entry is not in
BENCHMARK.json: PERF.md, open questions) on the CPU at a small size, through
the harness as on the card (the chip check skipped): a sound run is
correct, also on crowded layouts where the agents collide and a team reward
falls inside the compared ticks; the lower-precision control and a skipped agent-collision phase are not. And
the readers of the trainer refill's two metrics on a made-up trace."""

import pytest
import torch

import harness as H
import run as R
from bench_helpers import short_episodes
from bench_scenes import SMALL, crowded_towers, drop_team_spirit, skip_agent_collisions

TOWER, EMPTY = "appo.towerbuilding_256x4", "sampler.empty_4096x1"
SEED = 2 ** 31 + 12345
# with four envs of crowded layouts, a seed whose sampled actions pay a
# team reward inside a compared rollout
TEAM_SEED = 2 ** 31 + 1
# the entry the waiting cell would have in BENCHMARK.json
EMPTY_ENTRY = dict(name=EMPTY, config="megaverse_sampler", traffic="empty_4096x1", chips=1)


def with_waiting_cell(monkeypatch) -> None:
    """The harness reads BENCHMARK.json with the waiting cell's entry added."""
    real = H.load_benchmark

    def load(*args, **kwargs):
        bench = real(*args, **kwargs)
        if all(w["name"] != EMPTY for w in bench["workloads"]):
            bench["workloads"].append(EMPTY_ENTRY)
        return bench

    monkeypatch.setattr(H, "load_benchmark", load)


def run_small(monkeypatch, name: str, seed: int, control: bool = False, crowded: bool = False,
              fault=None, num_envs: int = 2) -> dict:
    torch.set_num_threads(2)
    short_episodes(0)
    if name == EMPTY:
        with_waiting_cell(monkeypatch)
    if crowded:
        crowded_towers(monkeypatch)
    if fault is not None:
        fault(monkeypatch)
    overrides = {part: dict(values) for part, values in SMALL[name].items()}
    overrides["traffic"].update(num_envs=num_envs, check_envs=num_envs)
    cell = H.Cell(H.load_benchmark(), name)
    for part, values in overrides.items():
        getattr(cell, part).update(values)
    return R.run_cell(cell, seed, 0.05, 0, device_type="cpu", control=control,
                      overrides=overrides)


@pytest.mark.parametrize("name, crowded", [(TOWER, False), (TOWER, True), (EMPTY, False)])
def test_sound_run_is_correct(monkeypatch, name, crowded):
    res = run_small(monkeypatch, name, SEED, crowded=crowded)
    assert H.is_correct(res["checks"]), res["checks"]
    assert res["checks"]["resets_unchecked"][0] == 0
    assert res["checks"]["state_gap"][0] == 0.0


@pytest.mark.parametrize("name", [TOWER, EMPTY])
def test_control_is_not_correct(monkeypatch, name):
    res = run_small(monkeypatch, name, SEED + 1, control=True)
    assert not H.is_correct(res["checks"]), res["checks"]


def test_skipped_agent_collisions_are_not_correct(monkeypatch):
    res = run_small(monkeypatch, TOWER, SEED + 2, crowded=True, fault=skip_agent_collisions)
    assert not H.is_correct(res["checks"]), res["checks"]
    assert res["checks"]["state_gap"][0] > res["checks"]["state_gap"][1]


def test_dropped_team_spirit_moves_the_state_gap(monkeypatch):
    """The reference pays the team reward that the faulty program does not:
    `state_gap` (the rewards and the state's reward leaves) reads off the
    sound run's exact 0. The change is team spirit x the reward (0.1 x 0.1
    for a visit of the zone with an object, 0.0075 here), far inside
    `state_gap`'s limit, so `correct` does not turn on it: a reward leaf
    needs a limit of its own (PERF.md, open questions)."""
    sound = run_small(monkeypatch, TOWER, TEAM_SEED, crowded=True, num_envs=4)
    assert sound["checks"]["state_gap"][0] == 0.0
    res = run_small(monkeypatch, TOWER, TEAM_SEED, crowded=True, num_envs=4,
                    fault=drop_team_spirit)
    assert res["checks"]["state_gap"][0] > 0.0, res["checks"]


def _trace(labels, kernels, window=(0.0, 1.0)):
    return H.TraceSummary(kernels, {}, labels, window)


def test_refill_ms_reads_the_outermost_refill_span():
    read = H.load_metric("refill_ms_per_iteration").read
    labels = [(0.50, 0.60, "megaverse.refill"), (0.52, 0.55, "megaverse.refill.poll"),
              (0.56, 0.59, "megaverse.refill.upload"), (0.10, 0.40, "megaverse.rollout"),
              (0.95, 1.20, "megaverse.refill")]    # runs past the window's end
    got = read({"trace": _trace(labels, [("k", 0.0, 1.0)]), "trace_iterations": 1})
    assert got == pytest.approx(1e3 * (0.10 + 0.05))
    assert read({"trace": _trace([(0.1, 0.4, "megaverse.rollout")], [("k", 0, 1)]),
                 "trace_iterations": 1}) is None
    assert read({}) is None


def test_refill_idle_reads_the_idle_under_the_refill_spans():
    read = H.load_metric("idle_ms_per_iteration.refill").read
    labels = [(0.50, 0.70, "megaverse.refill"), (0.50, 0.55, "megaverse.refill.poll"),
              (0.60, 0.65, "megaverse.refill.upload"), (0.00, 0.50, "megaverse.rollout")]
    # busy 0-0.52 and 0.62-1.0: idle 0.52-0.62, all of it under refill spans
    kernels = [("a", 0.0, 0.52), ("b", 0.62, 1.0)]
    got = read({"trace": _trace(labels, kernels), "trace_iterations": 2})
    assert got == pytest.approx(1e3 * 0.10 / 2)
    assert read({"trace": _trace(labels[3:], kernels), "trace_iterations": 1}) is None
