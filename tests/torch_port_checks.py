"""Shared checks of tests/test_torch_*.py: the port (megaverse_tpu_torch) held
against the JAX package on the CPU, scenario by scenario.

Not a test module. The functions take scenario names, so each test file
states which scenarios it covers and with which seeds.

Tolerances of the scripted runs (the ones tests/test_torch_env.py uses): per
tick pos / yaw / pitch / vvel agree to atol 1e-4 (float32 last-place
differences of sin/cos/sqrt between the runtimes, accumulated over the ticks;
hvel = displacement / dt to 2e-3), rewards to 1e-5; dones, true objective,
carried props, prop flags, grids and the scenario's own state are equal.
"""

import numpy as np

import jax.numpy as jnp
import torch

import megaverse_tpu.constants as C
from megaverse_tpu import VectorEnv as JVectorEnv
from megaverse_tpu.scenarios import make_scenario as j_make_scenario
from megaverse_tpu.utils.refrng import Rng as JRng, episode_reseed as j_episode_reseed

from megaverse_tpu_torch import VectorEnv as TVectorEnv
from megaverse_tpu_torch import convert
from megaverse_tpu_torch.scenarios import make_scenario as t_make_scenario
from megaverse_tpu_torch.utils.refrng import Rng as TRng, episode_reseed as t_episode_reseed

# The port tests' tensors are small: one intra-op thread runs them faster than
# many and leaves the cores to the other test workers. Every port test module
# imports this one.
torch.set_num_threads(1)

F, B_, L, R_ = C.ACTION_FORWARD, C.ACTION_BACKWARD, C.ACTION_LEFT, C.ACTION_RIGHT
LL, LR, LD = C.ACTION_LOOK_LEFT, C.ACTION_LOOK_RIGHT, C.ACTION_LOOK_DOWN
J, I = C.ACTION_JUMP, C.ACTION_INTERACT
# walk, look, jump, pick up, carry, put down: 30 ticks
SCRIPT = ([I] + [F] * 3 + [F | LL] * 3 + [F | J] + [B_] * 4 + [I] + [F | LD] * 3 + [I]
          + [R_] * 3 + [I] + [F] * 4 + [I] + [B_ | LR] * 4)
assert len(SCRIPT) == 30


def script_actions(t, shape=(2, 2)):
    act = np.full(shape, SCRIPT[t], np.int32)
    act[:, 1:] = SCRIPT[(t + 7) % len(SCRIPT)]
    return act


def assert_trees_equal(got, want, path=""):
    if want is None:
        assert got is None, path
        return
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}.{k}")
        return
    assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=path)


def assert_layouts_equal(name, agents, mode, n=3, params=None):
    """The same seed gives layouts that are EQUAL leaf for leaf in both
    packages (generation is host-side numpy in both); mode is the rng mode,
    "numpy" or "reference"."""
    jsc = j_make_scenario(name, num_agents=agents, params=params)
    tsc = t_make_scenario(name, num_agents=agents, params=params)
    assert jsc.cfg.prop_segments == tsc.cfg.prop_segments
    assert jsc.cfg.grid.dims == tsc.cfg.grid.dims and jsc.max_boxes == tsc.max_boxes
    assert dict(jsc.params) == dict(tsc.params)
    assert jsc.default_reward_shaping() == tsc.default_reward_shaping()
    if mode == "numpy":
        jr, tr = np.random.default_rng(123), np.random.default_rng(123)
        gen = lambda sc, rng: sc.generate_checked(rng)
    else:
        jr, tr = JRng(7), TRng(7)

        def gen(sc, rng):
            (j_episode_reseed if rng is jr else t_episode_reseed)(rng)
            return sc.generate_checked(rng, ref_stream=True)
    for _ in range(n):
        want = convert.to_numpy_tree(gen(jsc, jr))
        got = convert.tree_to_numpy(gen(tsc, tr))
        assert_trees_equal(got, want, name)


def set_agents(jenv, tenv, **fields):
    """Overwrite agent fields (numpy, [B, A, ...]) in both environments."""
    jenv.state = jenv.state.replace(agents=jenv.state.agents.replace(
        **{k: jnp.asarray(v) for k, v in fields.items()}))
    tenv.state = tenv.state.replace(agents=tenv.state.agents.replace(
        **{k: torch.from_numpy(np.array(v)) for k, v in fields.items()}))


def scripted_pair(name, seed, prepare, params=None, short_env0=1.4,
                  script=script_actions):
    """Both VectorEnvs (2 envs x 2 agents, no rendering) reset from `seed`,
    `prepare(jenv, tenv)` applied (state surgery from numpy, the same in
    both), env 0's episode cut to `short_env0` seconds so that one auto-reset
    happens inside the run, then stepped through len(SCRIPT) ticks of
    `script(t)` (int32 [2, 2] bitmasks; default: SCRIPT). Returns per-tick
    logs of each side."""
    kw = dict(num_envs=2, num_agents_per_env=2, seed=seed, render=False, params=params)
    jenv = JVectorEnv(name, **kw)
    tenv = TVectorEnv(name, device="cpu", **kw)
    jenv.reset()
    tenv.reset()
    assert_trees_equal(convert.tree_to_numpy(tenv.state.props),
                       convert.to_numpy_tree(jenv.state.props), "props after reset")
    if prepare is not None:
        prepare(jenv, tenv)
    short = np.asarray(jenv.state.episode_len_sec).copy()
    short[0] = short_env0
    jenv.state = jenv.state.replace(episode_len_sec=jnp.asarray(short))
    tenv.state = tenv.state.replace(episode_len_sec=torch.from_numpy(short.copy()))
    jlog, tlog = [], []
    for t in range(len(SCRIPT)):
        act = script(t)
        _, jr, jd, jo = jenv.step(act)
        _, tr, td, to = tenv.step(act)
        jlog.append(dict(state=convert.to_numpy_tree(jenv.state), reward=np.asarray(jr),
                         done=np.asarray(jd), tobj=np.asarray(jo)))
        tlog.append(dict(state=convert.tree_to_numpy(tenv.state), reward=tr.numpy(),
                         done=td.numpy(), tobj=to.numpy()))
    return dict(name=name, jenv=jenv, tenv=tenv, jlog=jlog, tlog=tlog)


def set_scen(jenv, tenv, **fields):
    """Overwrite scenario-state fields (numpy, [B, ...]) in both environments."""
    jenv.state = jenv.state.replace(scen=jenv.state.scen.replace(
        **{k: jnp.asarray(v) for k, v in fields.items()}))
    tenv.state = tenv.state.replace(scen=tenv.state.scen.replace(
        **{k: convert._tensor(v, "cpu") for k, v in fields.items()}))


def set_props(jenv, tenv, **fields):
    """Overwrite prop-table fields (numpy, [B, P, ...]) in both environments."""
    jenv.state = jenv.state.replace(props=jenv.state.props.replace(
        **{k: jnp.asarray(v) for k, v in fields.items()}))
    tenv.state = tenv.state.replace(props=tenv.state.props.replace(
        **{k: torch.from_numpy(np.array(v)) for k, v in fields.items()}))


def single_env(name, seed=0, num_agents=1, **params):
    """The port's counterpart of tests/test_scenarios.py::_single_env: one
    layout from numpy seed `seed` as a batch of one env (B = 1) on the CPU.
    Returns (scenario, state, shaping [1, A, K])."""
    from megaverse_tpu_torch.types import scene_to_device, stack_scenes, state_from_scene

    sc = t_make_scenario(name, num_agents=num_agents, params=params or None)
    scene = scene_to_device(stack_scenes([sc.generate(np.random.default_rng(seed))]), "cpu")
    state = state_from_scene(scene, num_agents, torch.zeros((1,), dtype=torch.int64))
    return sc, state, torch.from_numpy(sc.shaping_array()[None])


def assert_logs_match(run, scen_atol=None):
    """Tick by tick, with the tolerances in the module docstring. Returns the
    number of dones seen. `scen_atol` maps float fields of the scenario state
    that carry a simulated body (Football's ball) to their absolute
    tolerance; every other scenario field is compared for equality."""
    dones = 0
    for t, (j, p) in enumerate(zip(run["jlog"], run["tlog"])):
        where = f"{run['name']} tick {t}"
        ja, pa = j["state"]["agents"], p["state"]["agents"]
        for f, tol in (("pos", 1e-4), ("yaw", 1e-4), ("pitch", 1e-4), ("vvel", 1e-4),
                       ("hvel", 2e-3)):
            np.testing.assert_allclose(pa[f], ja[f], atol=tol, rtol=0, err_msg=f"{where} {f}")
        for f in ("jumping", "on_ground", "carried"):
            np.testing.assert_array_equal(pa[f], ja[f], err_msg=f"{where} {f}")
        np.testing.assert_allclose(p["reward"], j["reward"], atol=1e-5, err_msg=where)
        np.testing.assert_array_equal(p["done"], j["done"], err_msg=where)
        np.testing.assert_array_equal(p["tobj"], j["tobj"], err_msg=where)
        js, ps = j["state"], p["state"]
        for f in ("num_frames", "done", "cols", "vobj", "vterrain", "box_color"):
            np.testing.assert_array_equal(ps[f], js[f], err_msg=f"{where} {f}")
        for f in ("episode_sec", "total_reward", "box_lo", "box_hi"):
            np.testing.assert_allclose(ps[f], js[f], atol=1e-4, err_msg=f"{where} {f}")
        for f in ("type", "flags", "color"):
            np.testing.assert_array_equal(ps["props"][f], js["props"][f], err_msg=f"{where} {f}")
        for f in ("pos", "scale"):
            np.testing.assert_allclose(ps["props"][f], js["props"][f], atol=1e-4,
                                       err_msg=f"{where} props.{f}")
        pscen, jscen = ps["scen"], js["scen"]
        for f, tol in (scen_atol or {}).items():
            np.testing.assert_allclose(pscen[f], jscen[f], atol=tol, rtol=0,
                                       err_msg=f"{where} scen.{f}")
            pscen, jscen = dict(pscen), dict(jscen)
            del pscen[f], jscen[f]
        assert_trees_equal(pscen, jscen, f"{where} scen")
        dones += int(p["done"].sum())
    return dones


def stand_on(cell):
    """World position of an agent standing in voxel `cell`: capsule bottom on
    the voxel's floor."""
    return np.asarray(cell, np.float32) + np.asarray(
        [0.5, C.AGENT_HALF_HEIGHT + 0.01, 0.5], np.float32)


def face_box(box_pos):
    """World position (with yaw 0, pitch 0) from which an agent standing on
    the box's floor level has its pickup spot (1 m in front of the camera,
    0.44 m below it) inside the box's voxel."""
    b = np.asarray(box_pos, np.float32)
    return np.asarray([b[0], np.floor(b[1]) + C.AGENT_HALF_HEIGHT + 0.01, b[2] + 1.0],
                      np.float32)


def spawn_pos(cell):
    """World position of an agent spawned on voxel `cell` (scenario_default
    spawn: cell centre in x/z, agent height above the cell's floor)."""
    return np.asarray(cell, np.float32) + np.asarray([0.5, C.AGENT_HEIGHT, 0.5], np.float32)


def facing_wall(wall, gap):
    """Capsule center and yaw of an agent standing `gap` metres in front of
    the face of a y-rotated wall row (cx, cy, cz, hx, hy, hz, yaw), on the
    side nearer the maze's center, facing it."""
    c, s = np.cos(wall[6]), np.sin(wall[6])
    normal = np.array([s, 0.0, c])                 # the wall's local +v
    side = -1.0 if normal[0] * wall[0] + normal[2] * wall[2] > 0 else 1.0
    pos = (np.array([wall[0], C.AGENT_HALF_HEIGHT + 0.01, wall[2]])
           + side * normal * (wall[5] + C.AGENT_CAPSULE_RADIUS + gap))
    # forward is (-sin yaw, 0, -cos yaw): toward the wall
    yaw = wall[6] if side > 0 else wall[6] + np.pi
    return pos.astype(np.float32), np.float32(yaw)


def above_wall(wall, height=0.3):
    """Capsule center `height` metres above the top of a wall row."""
    return np.array([wall[0], 2 * wall[4] + C.AGENT_HALF_HEIGHT + height, wall[2]],
                    np.float32)


def wall_side(wall, pos):
    """Signed distance of a point [..., 3] from a wall row's mid-plane."""
    c, s = np.cos(wall[6]), np.sin(wall[6])
    return s * (pos[..., 0] - wall[0]) + c * (pos[..., 2] - wall[2])


# the hex scenes' scripted runs: wall rows agent 0 walks into, agent 1 stands on
WALL_AGENT0, WALL_AGENT1 = 0, 5


def hex_script(t):
    """Actions of the hex scenes' scripted runs (with place_at_walls).
    Agent 0: forward (into its wall), turning left on ticks 12-17. Agent 1:
    idle on its wall top, a jump at tick 12, forward from tick 21."""
    a0 = F | LL if 12 <= t < 18 else F
    a1 = J if t == 12 else (F if t > 20 else 0)
    return np.array([[a0, a1], [a0, a1]], np.int32)


def place_at_walls(st, pos, yaw, vvel, on_ground, envs=(0, 1)):
    """In each of `envs` (numpy state `st`, agent arrays edited in place):
    agent 0 1 m in front of wall WALL_AGENT0, facing it; agent 1 0.3 m above
    the top of wall WALL_AGENT1, falling."""
    for b in envs:
        walls = st["scen"]["wall_obbs"][b]
        pos[b, 0], yaw[b, 0] = facing_wall(walls[WALL_AGENT0], 1.0)
        pos[b, 1] = above_wall(walls[WALL_AGENT1])
        vvel[b, 1] = 0.0
        on_ground[b, 1] = False
