"""Scripted runs of the Obstacles variants with the larger grid and the wall,
step and gap platforms, port vs JAX package on the CPU.

The 30 ticks of tests/torch_port_checks.py (walk, look, jump, pick up, put
down; env 0 forced through an auto-reset) through both `VectorEnv`s at 2 envs
x 2 agents without rendering, with that module's tolerances: pos / yaw / pitch
/ vvel atol 1e-4, hvel 2e-3, rewards 1e-5; dones, true objective, prop flags,
grids and ObstaclesState equal. A file of its own so that the test workers
can run it beside tests/test_torch_obstacles.py (each run compiles a
reference step).
"""

import numpy as np
import pytest

import megaverse_tpu.constants as C

from megaverse_tpu_torch import convert

import torch_port_checks as K


def prepare_where_possible(jenv, tenv):
    """`prepare` for any variant: the second movable box of env 0, the exit
    pad and the lava of env 1 are used where the layout has them."""
    st = convert.to_numpy_tree(jenv.state)
    pos, yaw = st["agents"]["pos"].copy(), st["agents"]["yaw"].copy()
    if st["props"]["type"][0, 1] != C.PROP_NONE:
        pos[0, 0] = K.face_box(st["props"]["pos"][0, 1])
        yaw[0, 0] = 0.0
    for agent, flag in ((0, C.TERRAIN_EXIT), (1, C.TERRAIN_LAVA)):
        cells = np.argwhere((st["vterrain"][1] & flag) != 0)
        if len(cells):
            pos[1, agent] = K.stand_on(cells[0])
    K.set_agents(jenv, tenv, pos=pos, yaw=yaw)


# seeds whose layouts merge into few boxes: the reference's step compiles in
# time proportional to that bucket
@pytest.mark.parametrize("name,seed", [("ObstaclesHard", 52), ("ObstaclesWalls", 37)])
def test_scripted_run_of_other_variants_matches(name, seed):
    """The same 30 ticks through the variants with the larger grid and the
    wall, step and gap platforms (ObstaclesHard draws from all of them)."""
    run = K.scripted_pair(name, seed, prepare_where_possible)
    try:
        assert K.assert_logs_match(run) >= 1, "the forced time-out of env 0"
        tlog = run["tlog"]
        assert tlog[0]["state"]["scen"]["reached_exit"][1, 0]
        moved = np.abs(tlog[-1]["state"]["agents"]["pos"] - tlog[0]["state"]["agents"]["pos"])
        assert (moved > 0.1).any(), "the agents walk"
    finally:
        run["jenv"].close()
        run["tenv"].close()
