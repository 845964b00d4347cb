"""The PVS path (utils/pvs.py, ops/pvs.py, the cluster mask of
env.render_tables) and HexMemory through the port vs the JAX package on the
CPU.

- The port's numpy portal search `_py_pvs` equals its native `hex_pvs` on
  small mazes (mirror of tests/test_pvs.py::test_py_pvs_matches_native).
- `row_mask` equals the JAX package's on the same eyes, tables and walltops,
  bit for bit, the sentinel cases included: eye above the wall-top plane,
  outside every cell, PVS disabled (tests/test_pvs.py::test_row_mask_sentinel_fallbacks).
- A 30-tick scripted run of HexMemory (2 envs x 2 agents) through both
  `VectorEnv`s with the tolerances of tests/torch_port_checks.py: in env 0
  agent 0 collects a good object and agent 1 a bad one at tick 0, and the
  episode is cut short so that env 0 auto-resets; in env 1 agent 0 walks
  into a maze wall and agent 1 drops onto a wall top and jumps from it.
- At the run's end state, the bit-walk's plain version with the PVS cluster
  mask, as `render_tables` builds it by default, is bit-equal to the plain
  B1 image, and the mask removed at least one cluster that the frustum test
  kept (mirror of tests/test_pvs.py::test_pvs_cluster_mask_bit_identity).
- The HexMemory state of tests/test_render.py::test_pallas_cluster_cull_is_exact
  through the port's plain B1 and the JAX package's XLA table renderer: at
  most 1 per colour channel on fewer than 1e-4 of the pixels, the pixels
  where the port's float32 arithmetic is ill-conditioned set aside as
  tests/test_torch_render_forms.py does.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import megaverse_tpu.constants as C
from megaverse_tpu.ops import pvs as JPV
from megaverse_tpu.ops import raycast as JR
from megaverse_tpu.scenarios import make_scenario as j_make_scenario
from megaverse_tpu.types import AgentState as JAgentState

from megaverse_tpu_torch import VectorEnv as TVectorEnv, convert
from megaverse_tpu_torch.env import UNCULLED, RenderMode, render_tables
from megaverse_tpu_torch.ops import pvs as TPV
from megaverse_tpu_torch.ops import raycast as TR
from megaverse_tpu_torch.ops import raycast_cuda as TRC
from megaverse_tpu_torch.scenarios.hex import MAZE_SCALE, HexMemoryState
from megaverse_tpu_torch.utils import native
from megaverse_tpu_torch.utils.hexmaze import HoneycombMaze
from megaverse_tpu_torch.utils.pvs import _py_pvs, maze_portal_arrays

import torch_port_checks as K

SEED = 3      # both envs' first mazes are closed enough for PVS (walltop > 0)
H, W = 24, 128


def random_maze(rng):
    """tests/test_pvs.py::_random_maze on the port's HoneycombMaze."""
    size = int(rng.integers(2, 5))
    maze = HoneycombMaze(size, rng)
    nw = len(maze.interior_walls)
    keep = (set(map(int, rng.choice(nw, size=max(1, int(nw * 0.6)), replace=False)))
            if nw else set())
    return maze, keep


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_py_pvs_matches_native(seed):
    if not native.have_native():
        pytest.skip("native library unavailable (native/build.sh needs g++)")
    maze, keep = random_maze(np.random.default_rng(seed))
    neigh, open_, edge_pts = maze_portal_arrays(maze, keep)
    for budget in (4000, 50):   # 50 exercises budget-exhaustion rows
        out = native.hex_pvs(neigh, open_, edge_pts, budget)
        py = _py_pvs(neigh, open_, edge_pts, budget)
        np.testing.assert_array_equal(out[0].astype(bool), py,
                                      err_msg=f"seed={seed} budget={budget}")


def jax_row_mask(pos, centers, rows16, walltop, nrows):
    return np.asarray(jax.vmap(lambda p, c, r, w: JPV.row_mask(p, c, r, w, nrows, MAZE_SCALE))(
        jnp.asarray(pos), jnp.asarray(centers), jnp.asarray(rows16), jnp.asarray(walltop)))


def test_row_mask_matches_jax_on_hex_tables():
    """Eyes scattered over two HexMemory mazes' tables (one with PVS
    disabled), at heights below and above the wall tops and outside the
    maze: equal bits in both packages, and the sentinel where it must be."""
    sc = j_make_scenario("HexMemory", num_agents=1)
    rng = np.random.default_rng(0)
    layouts = []
    while len(layouts) < 2:     # one with PVS, one without
        scene = sc.generate_checked(rng)
        if (scene.scen.pvs_walltop > 0) != (len(layouts) == 1):
            layouts.append(scene.scen)
    centers = np.stack([s.pvs_centers for s in layouts])
    rows16 = np.stack([s.pvs_rows16 for s in layouts])
    walltop = np.stack([s.pvs_walltop for s in layouts])
    nrows = sc.cfg.max_props
    n = 64
    eye_off = C.AGENT_BODY_OFFSET_Y + C.AGENT_CAMERA_OFFSET_Y
    xz = rng.uniform(-30, 30, (2, n, 2))
    xz[:, -4:] = rng.uniform(60, 80, (2, 4, 2))             # outside every cell
    y = np.where(rng.random((2, n)) < 0.8, 0.9, walltop[:, None] + 0.5 - eye_off)
    pos = np.stack([xz[..., 0], y, xz[..., 1]], -1).astype(np.float32)
    want = jax_row_mask(pos, centers, rows16, walltop, nrows)
    got = TPV.row_mask(*(torch.from_numpy(np.asarray(a)) for a in (pos, centers, rows16,
                                                                      walltop)),
                       nrows, MAZE_SCALE).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, n, nrows)
    assert (~got[0]).any(), "no row masked: the comparison has no teeth"
    assert got[1].all(), "PVS disabled must give the sentinel"
    high = y[0] + eye_off >= walltop[0] - 0.05
    assert high.any() and got[0][high].all() and got[0][-4:].all()


def test_row_mask_sentinel_fallbacks():
    """tests/test_pvs.py::test_row_mask_sentinel_fallbacks on the port."""
    cmax, nrows = 4, 20
    centers = np.full((cmax, 2), 1e9, np.float32)
    centers[0] = (0.0, 0.0)
    centers[1] = (2 * MAZE_SCALE, 0.0)
    rows16 = np.zeros((cmax + 1, 2), np.int32)
    rows16[0, 0] = 0b101            # cell 0 sees rows {0, 2}
    rows16[1, 0] = 0b010
    rows16[cmax] = 0xFFFF           # sentinel: everything visible
    eye_off = C.AGENT_BODY_OFFSET_Y + C.AGENT_CAMERA_OFFSET_Y

    def mask(pos_xyz, wt=2.0):
        return TPV.row_mask(torch.tensor([[pos_xyz]], dtype=torch.float32),
                            torch.from_numpy(centers)[None], torch.from_numpy(rows16)[None],
                            torch.tensor([wt], dtype=torch.float32), nrows, MAZE_SCALE)[0, 0].numpy()

    m = mask([0.0, 0.5 - eye_off, 0.0])
    assert m[0] and not m[1] and m[2] and not m[3:].any()
    m = mask([2 * MAZE_SCALE, 0.5 - eye_off, 0.0])
    assert m[1] and not m[0]
    assert mask([0.0, 3.0 - eye_off, 0.0]).all()              # above the wall tops
    assert mask([50 * MAZE_SCALE, 0.5 - eye_off, 0.0]).all()  # outside every cell
    assert mask([0.0, 0.5 - eye_off, 0.0], wt=-1.0).all()     # PVS disabled


def prepare(jenv, tenv):
    """Env 0: agent 0 on a good object, agent 1 on a bad one. Env 1: agent 0
    in front of a wall, agent 1 above a wall top (K.place_at_walls)."""
    st = convert.to_numpy_tree(jenv.state)
    ag, scen = st["agents"], st["scen"]
    pos, yaw = ag["pos"].copy(), ag["yaw"].copy()
    vvel, on_ground = ag["vvel"].copy(), ag["on_ground"].copy()
    K.place_at_walls(st, pos, yaw, vvel, on_ground, envs=(1,))
    active = scen["obj_active"][0]
    for a, good in ((0, True), (1, False)):
        k = int(np.flatnonzero(active & (scen["obj_good"][0] == good))[0])
        pos[0, a] = scen["obj_pos"][0, k] * [1, 0, 1] + [0, C.AGENT_HALF_HEIGHT + 0.01, 0]
    K.set_agents(jenv, tenv, pos=pos, yaw=yaw, vvel=vvel, on_ground=on_ground)


@pytest.fixture(scope="module")
def scripted():
    run = K.scripted_pair("HexMemory", SEED, prepare, script=K.hex_script)
    yield run
    run["jenv"].close()
    run["tenv"].close()


def test_scripted_run_matches_tick_by_tick(scripted):
    # env 0 ends once, at its cut-short time-out
    assert K.assert_logs_match(scripted) == 1


def test_scripted_run_exercises_the_scenario(scripted):
    """Env 0 collects one good (+1 to agent 0) and one bad object (-1 to
    agent 1) at tick 0 and hides their props; env 1's agent 1 lands on its
    wall top."""
    tlog = scripted["tlog"]
    p0 = tlog[0]
    np.testing.assert_allclose(p0["reward"][0], [1.0, -1.0])
    sc0 = p0["state"]["scen"]
    assert sc0["good_collected"][0] == 1
    gone = ~sc0["obj_active"][0] & (sc0["obj_nprops"][0] > 0)
    assert gone.sum() == 2
    for k in np.flatnonzero(gone):
        first, n = sc0["obj_prop"][0, k], sc0["obj_nprops"][0, k]
        assert not (p0["state"]["props"]["flags"][0, first:first + n] & 2).any()
    walls = p0["state"]["scen"]["wall_obbs"][1]
    top = 2 * walls[K.WALL_AGENT1, 4] + C.AGENT_HALF_HEIGHT
    ys = np.array([p["state"]["agents"]["pos"][1, 1, 1] for p in tlog[:12]])
    grounded = np.array([p["state"]["agents"]["on_ground"][1, 1] for p in tlog[:12]])
    assert grounded.any() and np.abs(ys[grounded] - top).max() < 0.06


def small_frames(tenv):
    scenario = copy.copy(tenv.scenario)
    scenario.cfg = dataclasses.replace(scenario.cfg, obs_height=H)
    return scenario


def test_masked_bitwalk_equals_b1(scripted):
    """The default tables (bit-walk, PVS mask in its cull, the run's render
    bucket) through the bit-walk's plain version give B1's image exactly,
    and the mask culled at least one cluster the frustum test kept."""
    tenv = scripted["tenv"]
    scenario, st, bucket = small_frames(tenv), tenv.state, tenv._bucket
    masked = render_tables(scenario, st, bucket=bucket, mode=RenderMode())
    open_ = render_tables(scenario, st, bucket=bucket, mode=RenderMode(pvs=False))
    b1 = render_tables(scenario, st, bucket=bucket, mode=UNCULLED)
    on = TRC.cluster_bits(masked["clbits"], masked["clusters"].shape[1])
    off = TRC.cluster_bits(open_["clbits"], open_["clusters"].shape[1])
    assert not (on & ~off).any()
    assert (off & ~on).any(), "the PVS mask culled no cluster: the test has no teeth"
    img = TRC.render_packed(height=H, width=W, **masked)
    want = TRC.render_packed(height=H, width=W, **b1)
    assert torch.unique(want).numel() > 8
    assert torch.equal(img, want)


def test_b1_matches_jax_image():
    """The state of the HexMemory case of
    tests/test_render.py::test_pallas_cluster_cull_is_exact (2 envs x 2
    agents, seed 7, three random steps from numpy seed 0; the port's state
    equals the JAX package's, as the scripted run holds) through the port's
    plain B1 and the JAX package's XLA table renderer, from the same cams
    and the full prim table (24 px): rot-box, wall, cylinder, cone and
    sphere rows: at most 1 per colour channel on fewer than 1e-4 of the
    pixels, outside the pixels where float32 is ill-conditioned."""
    tenv = TVectorEnv("HexMemory", num_envs=2, num_agents_per_env=2, seed=7, render=False,
                      device="cpu")
    tenv.reset()
    rng = np.random.default_rng(0)
    for _ in range(3):
        tenv.step(np.stack([rng.integers(0, s, size=(2, 2)) for s in C.ACTION_SPACE_SIZES],
                           axis=-1))
    tabs = render_tables(small_frames(tenv), tenv.state, mode=UNCULLED)
    tenv.close()
    cams, prims = tabs["cams"], tabs["prims"]
    kinds = set(prims[..., 0].flatten().tolist())
    assert {TRC.PRIM_ROTBOX, TRC.PRIM_ROTBOX_WALL} <= kinds, kinds
    got = TRC.render_packed(cams, prims, H, W, ui_indicators=False).numpy()

    cfg = dataclasses.replace(j_make_scenario("Empty", num_agents=2).cfg, obs_height=H)

    def one(p, cam, ps):
        agents = JAgentState.create(ps.shape[0]).replace(pos=ps, yaw=cam[:, 3], pitch=cam[:, 4])
        return JR.render_table_packed(cfg, agents, p, cam[:, 5], last_reward=cam[:, 6])

    want = np.asarray(jax.jit(jax.vmap(one))(
        jnp.asarray(prims.numpy()), jnp.asarray(cams.numpy()),
        jnp.asarray(tenv.state.agents.pos.numpy())))
    unpack = lambda p: np.stack([(p >> 16) & 0xFF, (p >> 8) & 0xFF, p & 0xFF], -1).astype(np.int64)
    delta = np.abs(unpack(got) - unpack(want))
    assert len(np.unique(got)) > 8, "the image is not (nearly) constant"
    # As in tests/test_torch_render_forms.py::test_b1_matches_jax_image:
    # pixels where the port's own float32 arithmetic is ill-conditioned (the
    # same expression tree in float64 gives another colour) are set aside;
    # they must be few, and there the JAX colour is a nearby shade.
    img64 = TR.render_table_packed(cams.double(), prims.double(), H, W, False).numpy()
    sensitive = (unpack(got) != unpack(img64)).any(-1)
    assert sensitive.sum() <= 16
    assert (delta[sensitive] <= 8).all(), f"set-aside pixels: max delta {delta[sensitive].max()}"
    assert (delta[~sensitive] <= 1).all(), f"max channel delta {delta[~sensitive].max()}"
    assert (delta[~sensitive] != 0).any(-1).mean() < 1e-4


def test_convert_carries_hexmemory_state(scripted):
    assert convert.scen_class("HexMemory") is HexMemoryState
    jst = convert.to_numpy_tree(scripted["jenv"].state)
    tst = convert.state_from_numpy(jst, scen_cls=HexMemoryState)
    K.assert_trees_equal(convert.tree_to_numpy(tst.scen), jst["scen"], "scen")
