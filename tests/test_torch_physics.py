"""Port vs JAX package: kinematic character controller (ops/physics.py).

Single ticks: the same random agent states, actions and worlds go through
megaverse_tpu.ops.physics and megaverse_tpu_torch.ops.physics; results agree
to atol 1e-6 (float32 evaluations of the same expressions; sin/cos/sqrt of the
two runtimes may differ in the last place). Trajectories over tens of ticks
are held to atol 1e-4 (hvel, which is displacement / dt: 2e-3), which leaves
room for that last-place noise to accumulate through the integrator. The golden traces of the reference
controller (tests/golden/kcc_golden.txt) are replayed against the port with
the bounds the JAX package is held to, all ten scenes (nine with no wall
table, high_ledge_brush through its rotated wall box, `obbs`). The
rotated-wall passes (`_obb_push_xz`, `obb_floor_support`,
`resolve_obb_walls`) are held against the JAX functions on random agents
and walls to atol 1e-5 (both take sin/cos of the wall's yaw, which may
differ in the last place; a push is a few such products).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import megaverse_tpu.constants as C
from megaverse_tpu.ops import grid as JG
from megaverse_tpu.ops import physics as JP
from megaverse_tpu.types import AgentState as JAgentState, GridConfig as JGridConfig
from megaverse_tpu_torch.ops import grid as TG
from megaverse_tpu_torch.ops import physics as TP
from megaverse_tpu_torch.types import AgentState as TAgentState, GridConfig as TGridConfig

import torch_port_checks  # noqa: F401  (one intra-op torch thread)

DIMS, ORIGIN = (24, 12, 24), (-4.0, -2.0, -4.0)
JCFG = JGridConfig(dims=DIMS, voxel_size=1.0, origin=ORIGIN)
TCFG = TGridConfig(dims=DIMS, voxel_size=1.0, origin=ORIGIN)
DT = C.DEFAULT_DT
FIELDS = ("pos", "yaw", "pitch", "vvel", "hvel", "jumping", "on_ground")


def flat_world(wall_x=None, wall_z=None, ledge=False):
    v = np.zeros(DIMS, np.uint8)
    v[:, 0:2, :] = C.VOXEL_SOLID  # floor top at world y=0
    if wall_x is not None:
        v[int(np.floor(wall_x - ORIGIN[0])), 2:8, :] = C.VOXEL_SOLID
    if wall_z is not None:
        v[:, 2:8, int(np.floor(wall_z - ORIGIN[2]))] = C.VOXEL_SOLID
    if ledge:
        v[12:, 2, :] = C.VOXEL_SOLID
    return v


def to_jax_agents(d):
    return JAgentState.create(d["pos"].shape[0]).replace(
        **{k: jnp.asarray(v) for k, v in d.items()})


def to_torch_agents(d):
    a = d["pos"].shape[0]
    return TAgentState.create(1, a).replace(
        **{k: torch.from_numpy(np.asarray(v))[None] for k, v in d.items()})


def agent_dict(x=4.0, y=None, z=4.0, yaw=0.0, on_ground=True):
    y = C.AGENT_HALF_HEIGHT if y is None else y
    return dict(pos=np.array([[x, y, z]], np.float32), yaw=np.array([yaw], np.float32),
                on_ground=np.array([on_ground]))


@pytest.fixture(scope="module")
def jax_tick():
    """One compiled JAX tick shared by every test of the module."""
    @jax.jit
    def tick(agents, action, cols):
        agents = JP.apply_look(agents, action, DT, 0.2)
        agents = JP.apply_acceleration(agents, action, DT)
        return JP.player_step(JCFG, None, agents, DT, cols=cols)
    return tick


def torch_tick(agents, action, cols):
    agents = TP.apply_look(agents, action, DT, 0.2)
    agents = TP.apply_acceleration(agents, action, DT)
    return TP.player_step(TCFG, agents, DT, cols=cols)


def compare(ja, ta, atol, where=""):
    """ja: JAX AgentState [A,...]; ta: port AgentState [1,A,...]. hvel is the
    tick's displacement / dt, so it magnifies a last-place difference in pos
    by 15: its bound is 20x the others'."""
    for f in FIELDS:
        want = np.asarray(getattr(ja, f))
        got = getattr(ta, f)[0].numpy()
        if want.dtype == bool:
            np.testing.assert_array_equal(got, want, err_msg=f"{where} {f}")
        else:
            tol = 20 * atol if f == "hvel" else atol
            np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=f"{where} {f}")


@pytest.mark.parametrize("seed", range(4))
def test_single_tick_random_states_match(jax_tick, seed):
    """One agent in a walled room with a random pose, velocity and action:
    16 draws per seed, the port taking them as one batch."""
    rng = np.random.default_rng(seed)
    v = flat_world(wall_x=8.0, wall_z=2.0, ledge=True)
    n = 16
    d = dict(
        pos=np.stack([rng.uniform(4.2, 7.9, n), rng.uniform(0.855, 2.5, n),
                      rng.uniform(3.2, 9.0, n)], -1).astype(np.float32),
        yaw=rng.uniform(-3.1, 3.1, n).astype(np.float32),
        pitch=rng.uniform(-0.2, 0.2, n).astype(np.float32),
        vvel=rng.uniform(-6, 6, n).astype(np.float32),
        hvel=np.stack([rng.uniform(-4, 4, n), np.zeros(n), rng.uniform(-4, 4, n)],
                      -1).astype(np.float32),
        jumping=rng.random(n) < 0.3, on_ground=rng.random(n) < 0.6)
    action = rng.integers(0, 2048, n).astype(np.int32)
    jcols = JG.pack_solid_columns(JCFG, jnp.asarray(v))
    tcols = torch.from_numpy(TG.pack_solid_columns_np(v))[None].expand(n, -1, -1, -1)
    ta = TAgentState.create(n, 1).replace(
        **{k: torch.from_numpy(val)[:, None] for k, val in d.items()})
    ta = torch_tick(ta, torch.from_numpy(action)[:, None], tcols)
    for i in range(n):
        ja = jax_tick(to_jax_agents({k: val[i:i + 1] for k, val in d.items()}),
                      jnp.asarray(action[i:i + 1]), jcols)
        compare(ja, ta.replace(**{f: getattr(ta, f)[i:i + 1] for f in FIELDS}), 1e-6,
                where=f"draw {i}")


SCRIPTS = {
    "settle": (dict(y=3.0, on_ground=False), {}, [0] * 30),
    "walk": (dict(), {}, [C.ACTION_FORWARD] * 40),
    "friction": (dict(), {}, [C.ACTION_FORWARD] * 20 + [0] * 20),
    "wall": (dict(x=6.0, yaw=-np.pi / 2), dict(wall_x=8.0), [C.ACTION_FORWARD] * 60),
    "jump": (dict(), {}, [C.ACTION_JUMP] + [0] * 40),
    "ledge": (dict(x=6.0, yaw=-np.pi / 2), dict(ledge=True), [C.ACTION_FORWARD] * 40),
    "glance": (dict(x=6.0, z=8.0, yaw=-np.pi / 4), dict(wall_x=8.0),
               [C.ACTION_FORWARD] * 60),
    "corner": (dict(x=6.0, z=4.0, yaw=-np.pi / 4), dict(wall_x=8.0, wall_z=2.0),
               [C.ACTION_FORWARD] * 80),
    "look_strafe_jump": (dict(x=5.0, z=6.0, yaw=0.4), dict(wall_x=8.0),
                         [C.ACTION_LEFT | C.ACTION_LOOK_LEFT] * 15
                         + [C.ACTION_FORWARD | C.ACTION_JUMP | C.ACTION_LOOK_UP] * 5
                         + [C.ACTION_RIGHT | C.ACTION_BACKWARD | C.ACTION_LOOK_DOWN] * 25),
}


@pytest.fixture(scope="module")
def trajectories(jax_tick):
    """Every script at once in the port: the scripts are the envs of one batch
    (B = 9, one agent each, a world per env). Shorter scripts idle to the
    common length."""
    names = sorted(SCRIPTS)
    length = max(len(SCRIPTS[n][2]) for n in names)
    worlds = np.stack([flat_world(**SCRIPTS[n][1]) for n in names])
    starts = [agent_dict(**SCRIPTS[n][0]) for n in names]
    acts = np.array([SCRIPTS[n][2] + [0] * (length - len(SCRIPTS[n][2])) for n in names],
                    np.int32)                                     # [B, L]
    ta = TAgentState.create(len(names), 1).replace(
        **{k: torch.from_numpy(np.stack([s[k] for s in starts])) for k in starts[0]})
    tcols = torch.from_numpy(np.stack([TG.pack_solid_columns_np(v) for v in worlds]))
    tlog = []
    for i in range(length):
        ta = torch_tick(ta, torch.from_numpy(acts[:, i:i + 1].copy()), tcols)
        tlog.append({f: getattr(ta, f).numpy().copy() for f in FIELDS})
    # the JAX package steps one env at a time through the one compiled tick
    jlog = [dict() for _ in range(length)]
    per_env = []
    for b_, name in enumerate(names):
        ja = to_jax_agents(starts[b_])
        jcols = JG.pack_solid_columns(JCFG, jnp.asarray(worlds[b_]))
        rows = []
        for i in range(length):
            ja = jax_tick(ja, jnp.asarray(acts[b_, i:i + 1]), jcols)
            rows.append({f: np.asarray(getattr(ja, f)) for f in FIELDS})
        per_env.append(rows)
    jlog = [{f: np.stack([per_env[b_][i][f] for b_ in range(len(names))]) for f in FIELDS}
            for i in range(length)]
    return names, jlog, tlog


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_trajectory_matches(trajectories, name):
    """Scripted walks (the cases of tests/test_physics.py) through both
    packages, tick by tick, plus the behaviour each case stands for."""
    names, jlog, tlog = trajectories
    b = names.index(name)
    n = len(SCRIPTS[name][2])
    for i in range(n):
        for f in FIELDS:
            want, got = jlog[i][f][b], tlog[i][f][b]
            if want.dtype == bool:
                np.testing.assert_array_equal(got, want, err_msg=f"{name} tick {i} {f}")
            else:
                tol = 2e-3 if f == "hvel" else 1e-4
                np.testing.assert_allclose(got, want, atol=tol, rtol=0,
                                           err_msg=f"{name} tick {i} {f}")
    xs = [float(tlog[i]["pos"][b, 0, 0]) for i in range(n)]
    ys = [float(tlog[i]["pos"][b, 0, 1]) for i in range(n)]
    zs = [float(tlog[i]["pos"][b, 0, 2]) for i in range(n)]
    last = tlog[n - 1]
    speed = float(np.linalg.norm(last["hvel"][b, 0]))
    face = 8.0 - C.AGENT_CAPSULE_RADIUS + 1e-3
    if name == "settle":
        assert np.isclose(ys[-1], C.AGENT_HALF_HEIGHT, atol=1e-3) and bool(last["on_ground"][b, 0])
    elif name == "walk":
        assert 2.0 < speed <= C.KCC_MAX_HORIZONTAL_SPEED + 1e-3 and zs[-1] < 3.0
    elif name == "friction":
        assert speed < 1e-3
    elif name in ("wall", "ledge", "corner"):
        assert max(xs) <= face and max(xs) > 7.0
    elif name == "glance":
        # pinned against the wall while alongside it (it ends at z = -4), and
        # still sliding in -z
        pinned = [x for x, z in zip(xs, zs) if z > -3.5]
        assert len(pinned) >= 40 and 7.4 < max(pinned) <= face
        assert zs[-1] < zs[-5] - 0.1
    elif name == "jump":
        assert C.AGENT_HALF_HEIGHT + 0.8 < max(ys) < C.AGENT_HALF_HEIGHT + 1.8
        assert np.isclose(ys[-1], C.AGENT_HALF_HEIGHT, atol=1e-3)


def test_look_pitch_clamped():
    a = TAgentState.create(1, 1)
    for act, want in ((C.ACTION_LOOK_UP, 0.2), (C.ACTION_LOOK_DOWN, -0.2)):
        for _ in range(120):
            a = TP.apply_look(a, torch.tensor([[act]], dtype=torch.int32), DT, 0.2)
        assert np.isclose(float(a.pitch[0, 0]), want)


def test_agents_push_apart_matches():
    pos = np.array([[4.0, 0.855, 4.0], [4.1, 0.855, 4.0], [4.0, 0.855, 4.0]], np.float32)
    ja = JP.resolve_agent_collisions(JAgentState.create(3).replace(pos=jnp.asarray(pos)))
    ta = TP.resolve_agent_collisions(
        TAgentState.create(1, 3).replace(pos=torch.from_numpy(pos)[None]))
    np.testing.assert_allclose(ta.pos[0].numpy(), np.asarray(ja.pos), atol=1e-6)
    assert float(torch.linalg.vector_norm(ta.pos[0, 0] - ta.pos[0, 1])) > 0.3


def test_agents_pushed_at_wall_stay_outside_solids():
    """Two overlapping agents next to a wall: the push-out goes through the
    sweep, so neither ends up inside the wall (tests/test_physics.py
    mirrored)."""
    v = flat_world(wall_x=8.0)
    wall_face = 8.0 - C.AGENT_CAPSULE_RADIUS
    pos = np.array([[wall_face - 0.02, 0.855, 4.0], [wall_face - 0.25, 0.855, 4.0]], np.float32)
    ta = TP.resolve_agent_collisions(
        TAgentState.create(1, 2).replace(pos=torch.from_numpy(pos)[None]), TCFG,
        cols=torch.from_numpy(TG.pack_solid_columns_np(v))[None])
    assert float(ta.pos[0, 0, 0]) <= wall_face + 1e-3
    assert float(ta.pos[0, 1, 0]) < wall_face - 0.25


# ---------------------------------------------------------------------------
# Golden traces of the reference controller (tests/golden/kcc_golden.cpp).
# ---------------------------------------------------------------------------
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "kcc_golden.txt")
FLOOR = (-20, -1, -20, 20, 0, 20)
WORLDS = {
    "flat_walk": [FLOOR],
    "wall_glance": [FLOOR, (-20, 0, -4, 20, 3, -3)],
    "corner_stop": [FLOOR, (-20, 0, -4, 20, 3, -3), (3, 0, -20, 4, 3, 20)],
    "voxel_step_blocked": [FLOOR, (-20, 0, -6, 20, 1, -4)],
    "jump_land": [FLOOR],
    "ceiling_bump": [FLOOR, (-20, 2, -20, 20, 3, 20)],
    "ledge_fall": [(-20, -1, -5, 20, 0, 20), (-20, -4, -20, 20, -3, -5)],
    "corner_head_on": [FLOOR, (3, 0, -3, 4, 3, -2)],
    "corner_graze": [FLOOR, (3, 0, -3, 4, 3, -2)],
    "high_ledge_brush": [FLOOR],  # the non-voxel-aligned slab is an OBB
}
# Non-voxel-aligned bodies as rotated wall boxes (cx, cy, cz, hx, hy, hz,
# yaw), as tests/test_kcc_golden.py gives them; the slab spans y in
# [1.62, 3], z in [-4, -3].
OBB_WORLDS = {
    "high_ledge_brush": [(0.0, 2.31, -3.5, 20.0, 0.69, 0.5, 0.0)],
}
ACTIONS = {
    "flat_walk": [C.ACTION_FORWARD] * 40 + [0] * 20,
    "wall_glance": [C.ACTION_FORWARD] * 50,
    "corner_stop": [C.ACTION_FORWARD] * 50,
    "voxel_step_blocked": [C.ACTION_FORWARD] * 45,
    "jump_land": [C.ACTION_FORWARD] * 10 + [C.ACTION_FORWARD | C.ACTION_JUMP]
                 + [C.ACTION_FORWARD] * 30,
    "ceiling_bump": [0] * 3 + [C.ACTION_JUMP] + [0] * 26,
    "ledge_fall": [C.ACTION_FORWARD] * 55,
    "corner_head_on": [C.ACTION_FORWARD] * 50,
    "corner_graze": [C.ACTION_FORWARD] * 50,
    "high_ledge_brush": [C.ACTION_FORWARD] * 45,
}
# Position bounds (metres) of tests/test_kcc_golden.py, unchanged.
POS_TOL = {
    "flat_walk": 2e-4, "wall_glance": 6e-3, "corner_stop": 6e-3,
    "voxel_step_blocked": 6e-3, "jump_land": 2e-3, "ceiling_bump": 6e-3,
    "ledge_fall": 1e-4, "corner_head_on": 2e-3, "corner_graze": 2e-3,
    "high_ledge_brush": 0.12,
}


def parse_golden():
    scenes, cur = {}, None
    with open(GOLDEN) as f:
        for line in f:
            line = line.strip()
            if line.startswith("SCENE"):
                parts = line.split()
                cur = {"yaw": float(parts[2].split("=")[1]),
                       "start": [float(v) for v in parts[3].split("=")[1].split(",")],
                       "rows": []}
                scenes[parts[1]] = cur
            elif line == "END":
                cur = None
            elif cur is not None and line:
                cur["rows"].append([float(v) for v in line.split(",")])
    return {k: dict(v, rows=np.asarray(v["rows"], np.float64)) for k, v in scenes.items()}


def replay(names, scenes, obbs=None):
    """The named golden scenes as the envs of one batch through the port:
    [L, B, 7] rows of pos, hvel x/z, vvel, onGround per tick."""
    cfg = TGridConfig(dims=(40, 8, 40), voxel_size=1.0, origin=(-20.0, -4.0, -20.0))
    grids = []
    for name in names:
        vt = np.zeros(cfg.dims, np.uint8)
        for (x0, y0, z0, x1, y1, z1) in WORLDS[name]:
            ix = lambda v, o: int(round(v - o))
            vt[ix(x0, -20):ix(x1, -20), ix(y0, -4):ix(y1, -4),
               ix(z0, -20):ix(z1, -20)] |= C.VOXEL_SOLID
        grids.append(TG.pack_solid_columns_np(vt))
    cols = torch.from_numpy(np.stack(grids))
    agents = TAgentState.create(len(names), 1).replace(
        pos=torch.tensor([[scenes[n]["start"]] for n in names], dtype=torch.float32),
        yaw=torch.tensor([[scenes[n]["yaw"]] for n in names], dtype=torch.float32))
    length = max(len(ACTIONS[n]) for n in names)
    acts = np.array([ACTIONS[n] + [0] * (length - len(ACTIONS[n])) for n in names], np.int32)
    rows = []
    for i in range(length):
        agents = TP.apply_acceleration(agents, torch.from_numpy(acts[:, i:i + 1].copy()), DT)
        agents = TP.player_step(cfg, agents, DT, cols=cols, obbs=obbs)
        rows.append(np.concatenate([
            agents.pos[:, 0].numpy(), agents.hvel[:, 0].numpy()[:, [0, 2]],
            agents.vvel.numpy(), agents.on_ground.numpy().astype(np.float64)], axis=1))
    return np.asarray(rows, np.float64)


@pytest.fixture(scope="module")
def golden_runs():
    """Golden scene -> (its rows, its per-tick port rows). The scenes with
    no rotated walls run as one batch with `obbs=None` (the path of every
    scenario but the hex ones); those with walls as a second batch through
    their wall table."""
    scenes = parse_golden()
    plain = sorted(n for n in WORLDS if n not in OBB_WORLDS)
    walled = sorted(OBB_WORLDS)
    obbs = torch.tensor([OBB_WORLDS[n] for n in walled], dtype=torch.float32)
    out = {}
    for names, rows in ((plain, replay(plain, scenes)),
                        (walled, replay(walled, scenes, obbs=obbs))):
        for i, name in enumerate(names):
            out[name] = (scenes[name]["rows"], rows[:len(ACTIONS[name]), i])
    return out


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_kcc_golden_trace(golden_runs, name):
    want, got = golden_runs[name]
    assert got.shape[0] == want.shape[0]
    dpos = np.abs(got[:, 0:3] - want[:, 1:4]).max(axis=1)
    assert float(dpos.max()) <= POS_TOL[name], (
        f"{name}: max per-tick position divergence {dpos.max():.5f} "
        f"(first offender tick {int(np.argmax(dpos))})")
    dv = np.abs(got[:, 5] - want[:, 6])
    assert float(np.sort(dv)[-3]) <= 0.4, f"{name}: vvel diverges {dv.max():.4f}"
    og = np.abs(got[:, 6] - want[:, 8])
    assert og.mean() <= 0.1, f"{name}: onGround disagrees on {og.mean():.0%} of ticks"


# ---------------------------------------------------------------------------
# Rotated wall boxes (the hex mazes' collision bodies).
# ---------------------------------------------------------------------------

def random_walls_and_agents(seed, num_envs=4, num_agents=3, num_walls=6):
    """Thin y-rotated walls (some inert) with agents scattered around and
    into them: inside, touching, crossed over since the previous position,
    above the tops and beside the ends."""
    rng = np.random.default_rng(seed)
    w = np.zeros((num_envs, num_walls, 7), np.float32)
    w[..., 0] = rng.uniform(-3, 3, (num_envs, num_walls))
    w[..., 3] = rng.uniform(0.5, 2.0, (num_envs, num_walls))
    w[..., 4] = rng.uniform(0.85, 1.4, (num_envs, num_walls))
    w[..., 1] = w[..., 4]
    w[..., 2] = rng.uniform(-3, 3, (num_envs, num_walls))
    w[..., 5] = 0.15
    w[..., 6] = rng.uniform(-np.pi, np.pi, (num_envs, num_walls))
    w[:, -1, 4] = -1.0                                  # inert padding row
    pick = rng.integers(0, num_walls - 1, (num_envs, num_agents))
    wall = np.take_along_axis(w, pick[..., None], axis=1)      # [B, A, 7]
    u = rng.uniform(-1.3, 1.3, (num_envs, num_agents)) * wall[..., 3]
    v = rng.uniform(-0.6, 0.6, (num_envs, num_agents))
    c, s_ = np.cos(wall[..., 6]), np.sin(wall[..., 6])
    x = wall[..., 0] + c * u + s_ * v
    z = wall[..., 2] - s_ * u + c * v
    y = np.where(rng.random((num_envs, num_agents)) < 0.25,
                 2 * wall[..., 4] + C.AGENT_HALF_HEIGHT + rng.uniform(-0.1, 0.2),
                 C.AGENT_HALF_HEIGHT)
    pos = np.stack([x, y, z], -1).astype(np.float32)
    prev = pos + rng.uniform(-0.3, 0.3, pos.shape).astype(np.float32)
    prev[..., 1] = pos[..., 1]
    return w, pos, prev


@pytest.mark.parametrize("seed", range(3))
def test_obb_push_and_floor_support_match(seed):
    w, pos, prev = random_walls_and_agents(seed)
    tw, tpos, tprev = (torch.from_numpy(a) for a in (w, pos, prev))
    got_push = TP._obb_push_xz(tpos, tw, tprev).numpy()
    got_top, got_found = (t.numpy() for t in TP.obb_floor_support(tpos, tw))
    moved = 0
    for b in range(w.shape[0]):
        jw, jpos, jprev = (jnp.asarray(a[b]) for a in (w, pos, prev))
        want_push = np.asarray(JP._obb_push_xz(jpos, jw, jprev))
        np.testing.assert_allclose(got_push[b], want_push, atol=1e-5, rtol=0,
                                   err_msg=f"env {b} push")
        want_top, want_found = (np.asarray(a) for a in JP.obb_floor_support(jpos, jw))
        np.testing.assert_array_equal(got_found[b], want_found, err_msg=f"env {b}")
        # -inf where no wall is near, in both
        np.testing.assert_allclose(got_top[b], want_top, atol=1e-5, rtol=0,
                                   err_msg=f"env {b} top")
        moved += int((np.abs(want_push - pos[b]) > 1e-4).any(-1).sum())
    assert moved >= 3, "too few agents pushed: the draw misses the walls"
    assert got_found.any() and not got_found.all()
    assert np.isneginf(got_top[~got_found]).all()


def test_resolve_obb_walls_matches():
    w, pos, prev = random_walls_and_agents(7)
    hvel = np.random.default_rng(7).uniform(-3, 3, pos.shape).astype(np.float32)
    hvel[..., 1] = 0.0
    ta = TAgentState.create(*pos.shape[:2]).replace(
        pos=torch.from_numpy(pos), hvel=torch.from_numpy(hvel))
    got = TP.resolve_obb_walls(ta, torch.from_numpy(w), torch.from_numpy(prev))
    for b in range(w.shape[0]):
        ja = JAgentState.create(pos.shape[1]).replace(
            pos=jnp.asarray(pos[b]), hvel=jnp.asarray(hvel[b]))
        want = JP.resolve_obb_walls(ja, jnp.asarray(w[b]), jnp.asarray(prev[b]))
        np.testing.assert_allclose(got.pos[b].numpy(), np.asarray(want.pos), atol=1e-5)
        np.testing.assert_allclose(got.hvel[b].numpy(), np.asarray(want.hvel), atol=2e-4)
