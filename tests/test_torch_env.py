"""The slice as a whole: Empty and TowerBuilding through `VectorEnv`, port vs
JAX package on the CPU.

Layouts generated from the same seed must be EQUAL leaf for leaf in both rng
modes (generation is host-side numpy in both packages). A 30-tick scripted
action sequence (walk, look, jump, pick up, place; one env forced through an
auto-reset) is stepped through both `VectorEnv`s: per tick pos / yaw / pitch /
vvel agree to atol 1e-4 (float32 last-place differences of sin/cos/sqrt between
the runtimes, accumulated over the ticks; hvel = displacement / dt to 2e-3),
rewards to 1e-5, dones, true objective and carried props equal. The final frame
is held to the renderer tolerance (at most 1 per channel on < 1e-4 of pixels).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import megaverse_tpu.constants as C
from megaverse_tpu import VectorEnv as JVectorEnv
from megaverse_tpu.env import render_batch as j_render_batch
from megaverse_tpu.scenarios import make_scenario as j_make_scenario
from megaverse_tpu.utils.refrng import Rng as JRng, episode_reseed as j_episode_reseed

from megaverse_tpu_torch import VectorEnv as TVectorEnv
from megaverse_tpu_torch import convert
from megaverse_tpu_torch import env as TE
from megaverse_tpu_torch.scenarios import make_scenario as t_make_scenario
from megaverse_tpu_torch.types import tree_leaves, tree_map
from megaverse_tpu_torch.utils.refrng import Rng as TRng, episode_reseed as t_episode_reseed

import torch_port_checks  # noqa: F401  (one intra-op torch thread)

F, B_, L, R_ = C.ACTION_FORWARD, C.ACTION_BACKWARD, C.ACTION_LEFT, C.ACTION_RIGHT
LL, LR, LD = C.ACTION_LOOK_LEFT, C.ACTION_LOOK_RIGHT, C.ACTION_LOOK_DOWN
J, I = C.ACTION_JUMP, C.ACTION_INTERACT
SCRIPT = ([F] * 6 + [F | LL] * 3 + [F | J] + [F] * 4 + [I] + [F | LD] * 3 + [I]
          + [R_] * 3 + [I] + [F] * 4 + [I] + [B_ | LR] * 2)
SEED = 39   # with this seed the script picks up two boxes and places one
H = 24


def script_actions(t):
    act = np.full((2, 2), SCRIPT[t], np.int32)
    act[:, 1] = SCRIPT[(t + 7) % len(SCRIPT)]
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


@pytest.mark.parametrize("mode", ["numpy", "reference"])
@pytest.mark.parametrize("name,agents", [("Empty", 2), ("TowerBuilding", 2),
                                         ("TowerBuilding", 1)])
def test_layouts_equal_leaf_for_leaf(name, agents, mode):
    jsc = j_make_scenario(name, num_agents=agents)
    tsc = t_make_scenario(name, num_agents=agents)
    assert jsc.cfg.prop_segments == tsc.cfg.prop_segments
    assert jsc.cfg.grid.dims == tsc.cfg.grid.dims and jsc.max_boxes == tsc.max_boxes
    if mode == "numpy":
        jr, tr = np.random.default_rng(123), np.random.default_rng(123)
        gen = lambda sc, rng: sc.generate_checked(rng)
    else:
        jr, tr = JRng(7), TRng(7)
        def gen(sc, rng):
            (j_episode_reseed if rng is jr else t_episode_reseed)(rng)
            return sc.generate_checked(rng, ref_stream=True)
    for _ in range(4):
        want = convert.to_numpy_tree(gen(jsc, jr))
        got = convert.tree_to_numpy(gen(tsc, tr))
        assert_trees_equal(got, want, name)


def test_towerbuilding_reference_stream_layout():
    """tests/test_refrng_scenarios.py mirrored: golden values of a
    draw-for-draw libstdc++ replica of the reference episode sequence."""
    dims = [5, 15, 24, 3, 6, 2, 3, 9, 9, 10, 5]
    cand_head = [(3, 2, 7), (10, 2, 4), (9, 2, 18)]
    sc = t_make_scenario("TowerBuilding", num_agents=2)
    rng = TRng(7)
    assert t_episode_reseed(rng) == 81935403
    scene = sc.generate_ref(rng)
    h, length, width, bz_l, bz_w, mat_l, mat_w, bz_x, bz_z, mat_x, mat_z = dims
    np.testing.assert_array_equal(scene.scen.zone, [bz_x, bz_x + bz_l, bz_z, bz_z + bz_w])
    floor = (scene.host_vtype[:, 0, :] & C.VOXEL_SOLID) != 0
    assert floor[:length, :width].all()
    assert not floor[length:, :].any() and not floor[:, width:].any()
    assert ((scene.host_vtype[0, 1:h, :width] & C.VOXEL_OPAQUE) != 0).all()
    for i in range(2):
        exp = np.asarray(cand_head[i], np.float64) + [0.5, C.AGENT_HEIGHT, 0.5]
        np.testing.assert_allclose(scene.agent_spawn[i], exp, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(scene.agent_yaw, np.float32),
                                  np.asarray([4.23069382, 1.43952417], np.float32))
    n_props = int((scene.props.type != C.PROP_NONE).sum())
    assert n_props == 1 + mat_l * mat_w
    ox, oy, oz = cand_head[2]
    if not ((mat_x <= ox < mat_x + mat_l) and (mat_z <= oz < mat_z + mat_w)):
        oy = 1
    assert any(np.allclose(p, np.asarray([ox, oy, oz]) + 0.5) for p in scene.props.pos[:n_props])


@pytest.fixture(scope="module", params=["Empty", "TowerBuilding"])
def scripted(request):
    """Both VectorEnvs stepped through the script; per-tick logs of each."""
    name = request.param
    kw = dict(num_envs=2, num_agents_per_env=2, seed=SEED, render=False)
    jenv = JVectorEnv(name, **kw)
    tenv = TVectorEnv(name, device="cpu", **kw)
    jenv.reset()
    tenv.reset()
    # env 0 times out at tick 21 in both: one forced auto-reset inside the run
    short = np.asarray(jenv.state.episode_len_sec).copy()
    short[0] = 1.4
    jenv.state = jenv.state.replace(episode_len_sec=jnp.asarray(short))
    tenv.state = tenv.state.replace(episode_len_sec=torch.from_numpy(short.copy()))
    jlog, tlog = [], []
    for t in range(len(SCRIPT)):
        act = script_actions(t)
        _, jr, jd, jo = jenv.step(act)
        _, tr, td, to = tenv.step(act)
        jlog.append(dict(state=convert.to_numpy_tree(jenv.state), reward=np.asarray(jr),
                         done=np.asarray(jd), tobj=np.asarray(jo)))
        tlog.append(dict(state=convert.tree_to_numpy(tenv.state), reward=tr.numpy(),
                         done=td.numpy(), tobj=to.numpy()))
    out = dict(name=name, jenv=jenv, tenv=tenv, jlog=jlog, tlog=tlog)
    yield out
    jenv.close()
    tenv.close()


def test_scripted_run_matches_tick_by_tick(scripted):
    jlog, tlog = scripted["jlog"], scripted["tlog"]
    dones = 0
    for t, (j, p) in enumerate(zip(jlog, tlog)):
        where = f"{scripted['name']} tick {t}"
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
        for f in ("num_frames", "done", "cols", "vobj", "box_color"):
            np.testing.assert_array_equal(ps[f], js[f], err_msg=f"{where} {f}")
        for f in ("episode_sec", "total_reward", "box_lo", "box_hi"):
            np.testing.assert_allclose(ps[f], js[f], atol=1e-4, err_msg=f"{where} {f}")
        for f in ("type", "flags", "color"):
            np.testing.assert_array_equal(ps["props"][f], js["props"][f], err_msg=f"{where} {f}")
        for f in ("pos", "scale"):
            np.testing.assert_allclose(ps["props"][f], js["props"][f], atol=1e-4,
                                       err_msg=f"{where} props.{f}")
        dones += int(p["done"].sum())
    assert dones == 1, "exactly the forced time-out of env 0"
    assert tlog[-1]["state"]["num_frames"][0] < tlog[-1]["state"]["num_frames"][1]
    if scripted["name"] == "TowerBuilding":
        carried = np.stack([p["state"]["agents"]["carried"] for p in tlog])
        assert (carried >= 0).any(), "the script must pick up a box"
        assert sum(float(np.abs(p["reward"]).sum()) for p in tlog) > 0


def test_scripted_run_final_frame_matches(scripted):
    jenv, tenv = scripted["jenv"], scripted["tenv"]
    jscn, tscn = jenv.scenario, tenv.scenario
    jcfg, tcfg = jscn.cfg, tscn.cfg
    try:
        jscn.cfg = dataclasses.replace(jcfg, obs_height=H)
        tscn.cfg = dataclasses.replace(tcfg, obs_height=H)
        want = np.asarray(j_render_batch(jscn, jenv.state, backend="xla", fmt="packed"))
        got = TE.render_batch(tscn, tenv.state, fmt="packed").numpy()
        bucketed = TE.render_batch(tscn, tenv.state, fmt="packed", bucket=tenv._bucket).numpy()
    finally:
        jscn.cfg, tscn.cfg = jcfg, tcfg
    np.testing.assert_array_equal(bucketed, got)
    unpack = lambda p: np.stack([(p >> 16) & 0xFF, (p >> 8) & 0xFF, p & 0xFF], -1).astype(np.int64)
    delta = np.abs(unpack(got) - unpack(want))
    assert (delta <= 1).all(), f"max channel delta {delta.max()}"
    assert (delta != 0).any(-1).mean() < 1e-4
    assert len(np.unique(got)) > 10


@pytest.fixture(scope="module")
def tower_mid_run():
    env = TVectorEnv("TowerBuilding", num_envs=6, num_agents_per_env=2, seed=3,
                     render=False, device="cpu")
    env.reset()
    rng = np.random.default_rng(0)
    for _ in range(4):
        env.step(rng.integers(0, 2048, size=(6, 2)).astype(np.int32))
    yield env
    env.close()


@pytest.mark.parametrize("n_done", [0, 2, 4, 5, 6])
def test_deferred_reset_equals_inline_select(tower_mid_run, n_done):
    """env_step(defer_reset=True) + apply_deferred_resets (on the CPU the
    masked copy's plain version) == the inline full select, for none, some
    and all of the envs done."""
    env = tower_mid_run
    scn, nxt = env.scenario, env.next_scenes
    lens = env.state.episode_len_sec.clone()
    lens[torch.tensor([4, 1, 5, 0, 3, 2][:n_done], dtype=torch.long)] = 0.01
    # env_step advances the grids of the state it is given in place
    start = lambda: tree_map(torch.clone, env.state).replace(episode_len_sec=lens)
    act = torch.full((6, 2), C.ACTION_FORWARD, dtype=torch.int32)
    inline = TE.env_step(scn, start(), nxt, act, env.shaping)
    deferred = TE.env_step(scn, start(), nxt, act, env.shaping, defer_reset=True)
    assert int(inline.done.sum()) == n_done
    patched = TE.apply_deferred_resets(deferred.state, nxt, deferred.done)
    assert patched is deferred.state
    for a, b in zip(tree_leaves(patched), tree_leaves(inline.state)):
        assert torch.equal(a, b)
    assert TE.should_defer_reset(scn) and not TE.should_defer_reset(t_make_scenario("Empty"))


def test_seeds_determinism():
    """Fixed seed => identical observations across instances
    (tests/test_env.py::test_seeds_determinism mirrored)."""
    mk = lambda: TVectorEnv("TowerBuilding", num_envs=2, num_agents_per_env=1, seed=123,
                            device="cpu")
    e1, e2 = mk(), mk()
    for e in (e1, e2):
        e.scenario.cfg = dataclasses.replace(e.scenario.cfg, obs_height=H)
    o1, o2 = e1.reset(), e2.reset()
    assert o1.shape == (2, 1, H, 128, 3) and o1.dtype == torch.uint8
    assert torch.equal(o1, o2)
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    md = lambda r: np.stack([r.integers(0, s, size=(2, 1)) for s in C.ACTION_SPACE_SIZES], -1)
    for _ in range(6):
        o1, rew, done, tobj = e1.step(md(r1))
        o2, *_ = e2.step(md(r2))
    assert torch.equal(o1, o2) and rew.shape == (2, 1) and done.shape == (2,)
    e3 = TVectorEnv("TowerBuilding", num_envs=2, num_agents_per_env=1, seed=124, device="cpu")
    e3.scenario.cfg = e1.scenario.cfg
    assert not torch.equal(e3.reset(), e1.reset())
    for e in (e1, e2, e3):
        e.close()


def test_auto_reset_refill_and_step_many():
    """Short Empty episodes: every env finishes, restarts from the layout
    buffer and gets its slot refilled; step_many's chunks (overlapped and
    synchronous refill) keep the buffer valid; packed and rgb formats agree."""
    env = TVectorEnv("Empty", num_envs=3, num_agents_per_env=1, seed=1, device="cpu",
                     params={C.P_EPISODE_LENGTH_SEC: 1.0}, obs_format="packed")
    env.scenario.cfg = dataclasses.replace(env.scenario.cfg, obs_height=H)
    env.reset()
    pool = np.random.default_rng(2).integers(0, 2048, size=(5, 3, 1)).astype(np.int32)
    seen = 0
    for n in (7, 7, 7, 14):     # 2*7 < 15: overlapped refill; 14: synchronous
        obs, dones, csums = env.step_many(pool, n)
        seen += int(torch.stack(dones).sum())
        assert obs.dtype == torch.int32 and obs.shape == (3, 1, H, 128)
        assert int(csums[-1]) == int(obs.sum())
    env.flush()
    assert seen == 6 and env.num_refilled_envs == 6          # 35 ticks: 2 episodes each
    assert not bool(env.state.done.any())
    assert int(env.state.num_frames.max()) <= 15
    with pytest.raises(ValueError, match="shortest episode"):
        env.step_many(pool, 15)
    rgb = TVectorEnv.unpack_obs(env.render())
    assert rgb.dtype == torch.uint8 and rgb.shape == (3, 1, H, 128, 3)
    env.set_reward_shaping(1, 0, {C.P_TEAM_SPIRIT: 0.5})
    assert env.get_reward_shaping(1, 0)[C.P_TEAM_SPIRIT] == 0.5
    assert env.get_reward_shaping(0, 0)[C.P_TEAM_SPIRIT] == 0.0
    env.close()
