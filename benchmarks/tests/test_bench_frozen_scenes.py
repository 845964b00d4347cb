"""The frozen reference's TowerBuilding and Empty (`reference/sim/scenarios/
tower_building.py`, `empty.py`) against the program on the CPU, tick by
tick: the program's `VectorEnv` and the reference's `env_step` and renderer
from the same layout seed under the same actions agree exactly (every state
leaf, the team-mixed rewards, the dones, the 24-row frames) over 20 ticks
that hold a reset; a fault planted in the program breaks the agreement."""

import subprocess
import sys

import pytest
import torch

import harness as H
from bench_helpers import short_episodes
from bench_scenes import (FAULTS, crowded_towers, first_disagreement, side_by_side,
                          team_reward_ticks)

SEED = 2 ** 31 + 4242
# a seed of the crowded layouts whose random actions pay a team reward in
# the 20 ticks (at ticks 7 and 8)
TEAM_SEED = 0


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("name, agents, crowded", [("TowerBuilding", 4, False),
                                                   ("TowerBuilding", 4, True),
                                                   ("Empty", 1, False)])
def test_program_equals_the_frozen_reference(monkeypatch, name, agents, crowded):
    short_episodes(0)
    if crowded:
        crowded_towers(monkeypatch)
    readings, layout_gap = side_by_side(name, agents, TEAM_SEED if crowded else SEED)
    assert layout_gap == 0
    assert first_disagreement(readings) is None
    # a reset was among the ticks compared
    assert any(bool(ref["done"].any()) for _, ref in readings)
    if crowded:
        assert team_reward_ticks(readings), "no team reward in the compared ticks"


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_breaks_the_agreement(monkeypatch, fault):
    short_episodes(0)
    crowded_towers(monkeypatch)
    FAULTS[fault](monkeypatch)
    readings, layout_gap = side_by_side("TowerBuilding", 4, TEAM_SEED)
    assert layout_gap == 0
    got = first_disagreement(readings)
    assert got is not None
    if fault == "team_spirit_dropped":
        # from the first team reward on: the rewards and the state's reward
        # leaves
        tick = team_reward_ticks(readings)[0]
        prog, ref = readings[tick]
        assert got[0] == tick and not torch.equal(prog["reward"], ref["reward"]), got
    else:
        assert got[0] == 0, got


def test_the_frozen_scenes_are_found_by_the_folder_scan():
    code = ("from reference.sim.scenarios import make_scenario\n"
            "import sys\n"
            "for name, a in (('TowerBuilding', 4), ('Empty', 1)):\n"
            "    s = make_scenario(name, num_agents=a)\n"
            "    assert type(s).__module__.startswith('reference.sim.scenarios.'), s\n"
            "assert not any(m.split('.')[0] == 'megaverse_tpu_torch' for m in sys.modules)\n"
            "print('found')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=H.BENCH_DIR, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "found", out.stderr[-2000:]
