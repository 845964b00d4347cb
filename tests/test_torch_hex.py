"""HexExplore (and HexMemory's layouts) through the port vs the JAX package
on the CPU.

Layouts from the same seed are EQUAL leaf for leaf (numpy rng mode; hex
layouts have no reference-stream mode), wall boxes, PVS centers, row words
and wall-top planes included. A 30-tick scripted run of HexExplore (2 envs x
2 agents) goes through both `VectorEnv`s with the tolerances of
tests/torch_port_checks.py: in each env agent 0 walks into a maze wall (the
rotated wall boxes of ops/physics.py stop it) and agent 1 drops onto a wall
top, stands there and jumps; in env 1 agent 0 is put beside the violet
diamond, which solves the maze and ends the episode 0.3 s later; env 0's
episode is cut short, so both envs auto-reset inside the run.

The fused wall row (PROP_ROTBOX_WALL: a wall and its bottom edging in one
row) renders as its two plain rot-box rows do through the port's plain
renderer (mirror of tests/test_render.py::test_fused_wall_matches_two_rotbox_rows).
"""

import numpy as np
import pytest
import torch

import megaverse_tpu.constants as C

from megaverse_tpu_torch import convert
from megaverse_tpu_torch.ops import raycast as TR
from megaverse_tpu_torch.ops import raycast_cuda as TRC
from megaverse_tpu_torch.scenarios import make_scenario as t_make_scenario
from megaverse_tpu_torch.scenarios.hex import HexExploreState
from megaverse_tpu_torch.types import AgentState as TAgentState

import torch_port_checks as K

SEED = 2


@pytest.mark.parametrize("agents", [1, 2])
@pytest.mark.parametrize("name", ["HexExplore", "HexMemory"])
def test_layouts_equal_leaf_for_leaf(name, agents):
    K.assert_layouts_equal(name, agents, "numpy", n=3)


def prepare(jenv, tenv):
    st = convert.to_numpy_tree(jenv.state)
    ag = st["agents"]
    pos, yaw = ag["pos"].copy(), ag["yaw"].copy()
    vvel, on_ground = ag["vvel"].copy(), ag["on_ground"].copy()
    K.place_at_walls(st, pos, yaw, vvel, on_ground)
    # env 1's agent 0 beside the diamond instead: solved at tick 0
    pos[1, 0] = st["scen"]["reward_pos"][1] + np.array(
        [0.5, C.AGENT_HALF_HEIGHT + 0.01, 0.0], np.float32)
    K.set_agents(jenv, tenv, pos=pos, yaw=yaw, vvel=vvel, on_ground=on_ground)


@pytest.fixture(scope="module")
def scripted():
    run = K.scripted_pair("HexExplore", SEED, prepare, script=K.hex_script)
    yield run
    run["jenv"].close()
    run["tenv"].close()


def test_scripted_run_matches_tick_by_tick(scripted):
    # env 1 ends 0.3 s after its solve, env 0 at its cut-short time-out
    assert K.assert_logs_match(scripted) == 2


def test_scripted_run_exercises_the_scenario(scripted):
    """What the equalities stand on: agent 0 is stopped by its wall (never
    within the capsule radius of the face, though it walks into it for 12
    ticks), agent 1 lands on its wall top and jumps from it, env 1 is solved
    at tick 0 (exploreSolved to agent 0, the diamond hidden) and ends, env 0
    times out."""
    tlog = scripted["tlog"]
    walls = tlog[0]["state"]["scen"]["wall_obbs"]
    first_done = {b: next(t for t, p in enumerate(tlog) if p["done"][b]) for b in (0, 1)}
    assert first_done[1] < 8 and first_done[0] == 20, first_done
    w0 = walls[0, K.WALL_AGENT0]
    pos0 = np.stack([p["state"]["agents"]["pos"][0, 0] for p in tlog[:20]])
    gap = np.abs(K.wall_side(w0, pos0)) - w0[5] - C.AGENT_CAPSULE_RADIUS
    assert gap.min() > -1e-3 and gap[0] > 0.5
    assert gap[11] < 0.01, "agent 0 never reached its wall"
    w1 = walls[0, K.WALL_AGENT1]
    ys = np.array([p["state"]["agents"]["pos"][0, 1, 1] for p in tlog[:20]])
    top = 2 * w1[4] + C.AGENT_HALF_HEIGHT
    grounded = np.array([p["state"]["agents"]["on_ground"][0, 1] for p in tlog[:12]])
    assert grounded.any() and np.abs(ys[:12][grounded] - top).max() < 0.06
    assert ys[13:18].max() > top + 0.3, "no jump from the wall top"
    p0 = tlog[0]
    assert p0["reward"][1, 0] == pytest.approx(5.0) and p0["state"]["scen"]["solved"][1]
    prop = p0["state"]["scen"]["reward_prop"][1]
    vis = p0["state"]["props"]["flags"][1, prop:prop + 2] & 2
    assert not vis.any(), "the diamond was not hidden"


def test_convert_carries_hex_state(scripted):
    assert convert.scen_class("HexExplore") is HexExploreState
    jst = convert.to_numpy_tree(scripted["jenv"].state)
    tst = convert.state_from_numpy(jst, scen_cls=HexExploreState)
    K.assert_trees_equal(convert.tree_to_numpy(tst.scen), jst["scen"], "scen")


def test_fused_wall_matches_two_rotbox_rows():
    """A PROP_ROTBOX_WALL row renders as its wall and its derived bottom
    edging as two PROP_ROTBOX rows, through the port's plain renderer, up to
    sub-ulp slab arithmetic (at most 2 per channel on < 0.1 % of pixels)."""
    cfg = t_make_scenario("Empty", num_agents=1).cfg
    agents = TAgentState.create(1, 1).replace(
        pos=torch.tensor([[[0.0, 0.6, 0.0]]]), yaw=torch.tensor([[0.15]]),
        pitch=torch.tensor([[-0.1]]))
    cams = TRC.build_cams(cfg, agents, torch.ones(1), torch.zeros(1, 1))

    pal8 = np.round(np.asarray(C.PALETTE) * 255.0).astype(np.int64)
    packed = (pal8[:, 0] << 16) | (pal8[:, 1] << 8) | pal8[:, 2]
    wall_col = float(packed[C.COLOR_IDX["DARK_BLUE"]])
    edge_col = float(packed[C.COLOR_IDX["ORANGE"]])
    cx, cz, hx, hy, hz, yaw = 0.6, -4.0, 1.75, 1.1, 0.15, 0.7
    cyj, syj = np.cos(np.float32(yaw)), np.sin(np.float32(yaw))
    fused = np.zeros((1, 2, 12), np.float32)
    fused[..., 0] = -1
    fused[0, 0] = [TRC.PRIM_ROTBOX_WALL, cx, hy, cz, yaw, cyj, syj, wall_col, hx, hy, hz,
                   edge_col]
    split = np.zeros((1, 2, 12), np.float32)
    split[0, 0] = [TRC.PRIM_ROTBOX, cx, hy, cz, yaw, cyj, syj, wall_col, hx, hy, hz, 0.0]
    e_hx, e_hy = hx * C.WALL_EDGE_LEN_SCALE, hy * C.WALL_EDGE_H_FRAC
    split[0, 1] = [TRC.PRIM_ROTBOX, cx, e_hy, cz, yaw, cyj, syj, edge_col, e_hx, e_hy,
                   C.WALL_EDGE_HZ, 0.0]
    render = lambda p: TR.render_table_packed(cams, torch.from_numpy(p), cfg.obs_height,
                                              cfg.obs_width)[0, 0].numpy()
    img_f, img_s = render(fused), render(split)
    sky = img_s[0, 0]

    def major_colors(img):
        vals, counts = np.unique(img, return_counts=True)
        return {int(v) for v, c in zip(vals, counts) if c >= 10 and v != sky}

    cols_s = major_colors(img_s)
    assert len(cols_s) >= 2, "expected wall + edging shades in the split render"
    assert major_colors(img_f) == cols_s
    assert (img_f == img_s).mean() > 0.999
    a = np.stack([(img_f >> s) & 0xFF for s in (16, 8, 0)], -1).astype(int)
    b = np.stack([(img_s >> s) & 0xFF for s in (16, 8, 0)], -1).astype(int)
    assert np.abs(a - b).max() <= 2
