"""Port vs JAX package: the renderer (ops/raycast.py, ops/raycast_cuda.py).

On the CPU the port's `render_packed` takes the kernel's plain PyTorch version,
which is what these tests exercise; the CUDA kernel itself is held against that
plain version on the card by chip_smoke.py.

Images from the two packages are compared with the JAX package's own
cross-backend tolerance (tests/test_render.py): at most 1 per colour channel,
on fewer than 1e-4 of the pixels. The arithmetic is the same float32
expression tree; rsqrt/sin/cos of the two runtimes may differ in the last
place, which can move a colour by one step on an isolated pixel. Tables
(prims, cams, cluster AABBs, distances) agree to 1e-6; integer tables are
equal. All renders are 24 px high (3 tile rows), as in tests/test_render.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import megaverse_tpu.constants as C
from megaverse_tpu import VectorEnv as JVectorEnv
from megaverse_tpu.ops import raycast as JR
from megaverse_tpu.ops import raycast_pallas as JRP
from megaverse_tpu.scenarios import make_scenario as j_make_scenario
from megaverse_tpu.types import AgentState as JAgentState

from megaverse_tpu_torch import VectorEnv as TVectorEnv
from megaverse_tpu_torch import convert
from megaverse_tpu_torch.env import UNCULLED, render_batch, render_tables
from megaverse_tpu_torch.ops import raycast as TR
from megaverse_tpu_torch.ops import raycast_cuda as TRC
from megaverse_tpu_torch.scenarios import make_scenario as t_make_scenario
from megaverse_tpu_torch.scenarios.tower_building import TowerState
from megaverse_tpu_torch.utils.synthetic import synthetic_cams, synthetic_prims

import torch_port_checks  # noqa: F401  (one intra-op torch thread)

H, W = 24, 128
CAM_OFF = np.float32(C.AGENT_BODY_OFFSET_Y + C.AGENT_CAMERA_OFFSET_Y)


def unpack(p):
    p = np.asarray(p).astype(np.int64)
    return np.stack([(p >> 16) & 0xFF, (p >> 8) & 0xFF, p & 0xFF], -1)


def assert_images_close(got, want):
    delta = np.abs(unpack(got) - unpack(want))
    assert (delta <= 1).all(), f"max channel delta {delta.max()} on {(delta > 1).sum()} values"
    frac = (delta != 0).any(-1).mean()
    assert frac < 1e-4, f"diff fraction {frac}"


# ---------------------------------------------------------------------------
# Synthetic table with rows of every type.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def synthetic():
    prims = synthetic_prims(seed=3, num_envs=2)
    cams = synthetic_cams(seed=3, prims=prims, num_agents=2)
    # eye = agent pos + camera offset in both packages: make that sum exact
    pos = cams[..., :3].copy()
    pos[..., 1] -= CAM_OFF
    cams[..., :3] = pos
    cams[..., 1] += CAM_OFF
    return prims, cams, pos


@pytest.fixture(scope="module")
def jax_table_render():
    """The JAX package's reference of its kernel (rolled XLA table renderer),
    compiled once per (ui) flag for [2 envs, 2 agents, 24 px]."""
    fns = {}

    def render(prims, cams, pos, ui):
        if ui not in fns:
            cfg = j_make_scenario("Empty", num_agents=2, params={
                C.P_USE_UI_REWARD_INDICATORS: 1.0 if ui else 0.0}).cfg
            cfg = dataclasses.replace(cfg, obs_height=H)

            def one(p, cam, ps):
                agents = JAgentState.create(ps.shape[0]).replace(
                    pos=ps, yaw=cam[:, 3], pitch=cam[:, 4])
                return JR.render_table_packed(cfg, agents, p, cam[:, 5],
                                              last_reward=cam[:, 6])
            fns[ui] = jax.jit(jax.vmap(one))
        return np.asarray(fns[ui](jnp.asarray(prims), jnp.asarray(cams), jnp.asarray(pos)))
    return render


@pytest.mark.parametrize("ui", [False, True])
def test_plain_matches_jax_reference_on_all_types(synthetic, jax_table_render, ui):
    prims, cams, pos = synthetic
    assert set(np.unique(prims[..., 0]).astype(int)) == set(range(-1, 8))
    want = jax_table_render(prims, cams, pos, ui)
    got = TRC.render_packed(torch.from_numpy(cams), torch.from_numpy(prims), H, W,
                            ui_indicators=ui).numpy()
    assert len(np.unique(got)) > 100
    assert_images_close(got, want)


def _cull_tables(cams, prims):
    prims_p, clusters = TRC.build_clusters(prims)
    clusters, _ = TRC.build_superclusters(clusters)
    prims_p = TRC.pad_prims_to_clusters(prims_p, clusters)
    sclist, clbits, scdist, cdist = TRC.cull_bits(cams, clusters, H, W)
    return dict(prims=prims_p, clusters=clusters, sclist=sclist, clbits=clbits,
                scdist=scdist, cdist=cdist)


def test_bitwalk_order_equals_in_order_on_all_types(synthetic):
    """Inside the port: the culled traversal (per-tile cluster bits, far-plane
    start, row-index tie-break, front-to-back order) gives EXACTLY the in-order
    image; so does any cluster permutation."""
    prims, cams, _ = synthetic
    cams, prims = torch.from_numpy(cams), torch.from_numpy(prims)
    plain = TRC.render_packed(cams, prims, H, W, ui_indicators=True)
    tabs = _cull_tables(cams, prims)
    culled = TRC.render_packed(cams, height=H, width=W, ui_indicators=True, **tabs)
    assert torch.equal(culled, plain)
    # real culling happens: some tile drops some live cluster
    live = (tabs["clusters"][..., 0] < 1e29).sum().item() * cams.shape[1] * (H // 8)
    bits = TRC.cluster_row_mask(tabs["clbits"], tabs["prims"].shape[1])[..., ::8].sum().item()
    assert 0 < bits < live
    rng = np.random.default_rng(1)
    for _ in range(2):
        perm = rng.permutation(tabs["prims"].shape[1] // 8)
        rows = [g * 8 + j for g in perm for j in range(8)]
        shuf = TR.render_table_packed(cams, tabs["prims"], H, W, True, row_order=rows)
        assert torch.equal(shuf, plain)


def test_render_packed_on_cpu_counts_no_launch(synthetic):
    prims, cams, _ = synthetic
    before = dict(TRC.LAUNCHES)
    a = TRC.render_packed(torch.from_numpy(cams), torch.from_numpy(prims), H, W)
    b = TRC.render_packed_plain(torch.from_numpy(cams), torch.from_numpy(prims), H, W)
    assert torch.equal(a, b) and TRC.LAUNCHES == before


def test_frustum_cull_is_conservative(synthetic):
    """For sampled pixels, every cluster the pixel's ray reaches in front of the
    camera inside the far plane has its bit set in the pixel's tile."""
    prims, cams, _ = synthetic
    tabs = _cull_tables(torch.from_numpy(cams), torch.from_numpy(prims))
    g = tabs["clusters"].shape[1]
    surv = TRC.cluster_row_mask(tabs["clbits"], g * 8)[..., ::8].numpy()   # [B,A,T,G]
    cl = tabs["clusters"].numpy()
    rows, cols = np.arange(H)[:, None], np.arange(W)[None, :]
    tan_h = np.tan(np.deg2rad(C.CAMERA_FOV_DEG / 2))
    tan_v = tan_h * H / W
    u = ((cols + 0.5) / W * 2 - 1) * tan_h
    v = (1 - (rows + 0.5) / H * 2) * tan_v
    il = 1 / np.sqrt(u * u + v * v + 1)
    d0 = np.stack(np.broadcast_arrays(u * il, v * il, -il + 0 * u), -1)
    rng = np.random.default_rng(0)
    reached = 0
    for b in range(cams.shape[0]):
        for a in range(cams.shape[1]):
            ex, ey, ez, yaw, pitch = cams[b, a, :5].astype(np.float64)
            cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
            y1 = cp * d0[..., 1] - sp * d0[..., 2]
            z1 = sp * d0[..., 1] + cp * d0[..., 2]
            d = np.stack([cy * d0[..., 0] + sy * z1, y1, -sy * d0[..., 0] + cy * z1], -1)
            for _ in range(200):
                py, px = int(rng.integers(H)), int(rng.integers(W))
                dd = d[py, px]
                inv = 1.0 / np.where(np.abs(dd) < 1e-12, 1e-12, dd)
                t1 = (cl[b, :, 0:3] - [ex, ey, ez]) * inv
                t2 = (cl[b, :, 3:6] - [ex, ey, ez]) * inv
                tmin, tmax = np.minimum(t1, t2).max(-1), np.maximum(t1, t2).min(-1)
                reach = (tmax >= tmin) & (tmax > 0) & (tmin < C.CAMERA_FAR)
                reached += int(reach.sum())
                bad = [k for k in np.nonzero(reach)[0] if not surv[b, a, py // 8, k]]
                assert not bad, (b, a, py, px, bad)
    assert reached > 0


def test_pow_shininess_matches_float_pow():
    x = torch.linspace(0.0, 1.0, 1000)
    want = x.numpy().astype(np.float64) ** C.LIGHT_SHININESS
    np.testing.assert_allclose(TR.pow_shininess(x).numpy(), want, rtol=2e-4, atol=1e-30)
    np.testing.assert_allclose(TR.pow_shininess(x).numpy(),
                               np.asarray(JR.pow_shininess(jnp.asarray(x.numpy()))),
                               rtol=1e-6, atol=1e-30)


def test_unpack_rgb_matches():
    p = np.random.default_rng(0).integers(0, 1 << 24, size=(2, 3, 8, 16)).astype(np.int32)
    np.testing.assert_array_equal(TRC.unpack_rgb(torch.from_numpy(p)).numpy(),
                                  np.asarray(JRP.unpack_rgb(jnp.asarray(p))))


def test_pack_bits_uses_bit_31():
    sv = np.random.default_rng(0).random((2, 3, 70)) < 0.5
    sv[..., 31] = True
    words = TRC.pack_bits(torch.from_numpy(sv)).numpy().view(np.uint32)
    for j in range(70):
        np.testing.assert_array_equal((words[..., j // 32] >> (j % 32)) & 1, sv[..., j])


def test_ui_reward_indicators():
    """useUIRewardIndicators draws the green/red reward quads: green strip left
    of centre for positive lastReward, red right of centre for negative, absent
    at zero and when the param is off (tests/test_render.py mirrored)."""
    imgs = {}
    for on in (1.0, 0.0):
        env = TVectorEnv("Empty", num_envs=3, num_agents_per_env=1, seed=5, render=False,
                         device="cpu", params={C.P_USE_UI_REWARD_INDICATORS: on})
        env.scenario.cfg = dataclasses.replace(env.scenario.cfg, obs_height=H)
        env.reset()
        st = env.state.replace(last_reward=torch.tensor([[2.0], [-1.5], [0.0]]))
        imgs[on] = render_batch(env.scenario, st, fmt="packed").numpy()
        unculled = render_batch(env.scenario, st, fmt="packed", mode=UNCULLED).numpy()
        np.testing.assert_array_equal(imgs[on], unculled)
        env.close()

    def count_color(img, name):
        col = np.asarray(C.PALETTE[C.COLOR_IDX[name]]) * (0.3 + C.LIGHT_COLOR[0])
        target = (np.clip(col, 0, 1) * 255 + 0.5).astype(np.int64)
        return int((img == ((target[0] << 16) | (target[1] << 8) | target[2])).sum())

    on, off = imgs[1.0], imgs[0.0]
    assert count_color(on[0], "GREEN") > 0 and count_color(on[0], "RED") == 0
    assert count_color(on[1], "RED") > 0 and count_color(on[1], "GREEN") == 0
    assert count_color(on[2], "GREEN") == 0 and count_color(on[2], "RED") == 0
    assert count_color(off, "GREEN") == 0 and count_color(off, "RED") == 0


# ---------------------------------------------------------------------------
# A TowerBuilding state carried from the JAX package into the port.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tower():
    """JAX TowerBuilding state (2 envs x 2 agents, after reset, with looks,
    rewards and clocks set from numpy) and the same state converted into the
    port, plus both 24-px configs."""
    jenv = JVectorEnv("TowerBuilding", num_envs=2, num_agents_per_env=2, seed=11,
                      render=False)
    jenv.reset()
    rng = np.random.default_rng(4)
    jst = jenv.state
    jst = jst.replace(
        agents=jst.agents.replace(
            pitch=jnp.asarray(rng.uniform(-0.2, 0.2, (2, 2)).astype(np.float32)),
            yaw=jnp.asarray(rng.uniform(-3, 3, (2, 2)).astype(np.float32))),
        last_reward=jnp.asarray(rng.uniform(-1, 1, (2, 2)).astype(np.float32)),
        episode_sec=jnp.asarray(rng.uniform(1, 20, (2,)).astype(np.float32)))
    jcfg = dataclasses.replace(jenv.scenario.cfg, obs_height=H)
    tst = convert.state_from_numpy(convert.to_numpy_tree(jst), scen_cls=TowerState)
    tscn = t_make_scenario("TowerBuilding", num_agents=2)
    tscn.cfg = dataclasses.replace(tscn.cfg, obs_height=H)
    remaining = jnp.maximum(
        0.0, (jst.episode_len_sec - jst.episode_sec) / jst.episode_len_sec)
    jprims = jax.vmap(lambda s: JRP.build_prim_table(
        jcfg, s.box_lo, s.box_hi, s.box_color, s.props, s.agents))(jst)
    jcams = jax.vmap(lambda s, tf: JRP.build_cams(jcfg, s.agents, tf, s.last_reward))(
        jst, remaining)
    jenv.close()
    return dict(jst=jst, jcfg=jcfg, tst=tst, tscn=tscn, jprims=jprims, jcams=jcams,
                remaining=remaining)


def test_convert_roundtrip(tower):
    back = convert.tree_to_numpy(tower["tst"])
    orig = convert.to_numpy_tree(tower["jst"])
    for k in ("cols", "vobj", "box_lo", "box_color", "episode_len_sec"):
        np.testing.assert_array_equal(back[k], orig[k])
        assert back[k].dtype == orig[k].dtype
    for k in orig["props"]:
        np.testing.assert_array_equal(back["props"][k], orig["props"][k])
    for k in orig["scen"]:
        np.testing.assert_array_equal(back["scen"][k], orig["scen"][k])


def test_prim_table_and_cams_match(tower):
    tabs = render_tables(tower["tscn"], tower["tst"], mode=UNCULLED)
    np.testing.assert_allclose(tabs["prims"].numpy(), np.asarray(tower["jprims"]), atol=1e-6)
    np.testing.assert_allclose(tabs["cams"].numpy(), np.asarray(tower["jcams"]), atol=1e-6)
    assert tabs["prims"].shape[1] == 24 + 89 + 2 * 2


def test_cluster_tables_match(tower):
    jprims = tower["jprims"]
    tprims = torch.from_numpy(np.array(jprims))
    jp, jc = jax.vmap(JRP.build_clusters)(jprims)
    tp, tc = TRC.build_clusters(tprims)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(tc[..., :6].numpy(), np.asarray(jc)[..., :6], atol=1e-6)
    np.testing.assert_array_equal(tc[..., 6:].numpy(), np.asarray(jc)[..., 6:])
    jc2, js = jax.vmap(JRP.build_superclusters)(jc)
    tc2, ts = TRC.build_superclusters(tc)
    np.testing.assert_allclose(tc2.numpy(), np.asarray(jc2), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    np.testing.assert_array_equal(
        TRC.pad_prims_to_clusters(tp, tc2).numpy(),
        np.asarray(jax.vmap(JRP.pad_prims_to_clusters)(jp, jc2)))
    # the synthetic table covers the tags TowerBuilding never produces
    sp = synthetic_prims(seed=3, num_envs=2)
    _, jc = jax.vmap(JRP.build_clusters)(jnp.asarray(sp))
    _, tc = TRC.build_clusters(torch.from_numpy(sp))
    np.testing.assert_allclose(tc[..., :6].numpy(), np.asarray(jc)[..., :6], atol=1e-6)
    np.testing.assert_array_equal(tc[..., 6].numpy(), np.asarray(jc)[..., 6])
    assert set(tc[..., 6].numpy().ravel().astype(int)) == {-1, 0, 1, 2, 3, 4, 5, 6, 7, 8}


def _jax_cull(jprims, jcams):
    jp, jc = jax.vmap(JRP.build_clusters)(jprims)
    jc, _ = jax.vmap(JRP.build_superclusters)(jc)
    jp = jax.vmap(JRP.pad_prims_to_clusters)(jp, jc)
    return jp, jc, JRP.cull_bits(jcams, jc, H, W)


def test_cull_bits_match(tower):
    jp, jc, (jsl, jcb, jsd, jcd) = _jax_cull(tower["jprims"], tower["jcams"])
    tabs = _cull_tables(torch.from_numpy(np.array(tower["jcams"])),
                        torch.from_numpy(np.array(tower["jprims"])))
    np.testing.assert_allclose(tabs["cdist"].numpy(), np.asarray(jcd), rtol=1e-6)
    np.testing.assert_allclose(tabs["scdist"].numpy(), np.asarray(jsd), rtol=1e-6)
    np.testing.assert_array_equal(tabs["clbits"].numpy(), np.asarray(jcb))
    np.testing.assert_array_equal(tabs["sclist"].numpy(), np.asarray(jsl))
    assert tabs["clbits"].dtype == torch.int32 and tabs["sclist"].dtype == torch.int32


def test_plain_matches_jax_reference_on_tower(tower):
    jst, jcfg = tower["jst"], tower["jcfg"]
    want = np.asarray(jax.vmap(
        lambda s, p, tf: JR.render_table_packed(jcfg, s.agents, p, tf, last_reward=s.last_reward)
    )(jst, tower["jprims"], tower["remaining"]))
    got = render_batch(tower["tscn"], tower["tst"], fmt="packed").numpy()
    assert len(np.unique(got)) > 20
    assert_images_close(got, want)
    unculled = render_batch(tower["tscn"], tower["tst"], fmt="packed", mode=UNCULLED).numpy()
    np.testing.assert_array_equal(got, unculled)


def test_pallas_kernel_interpret_bitwalk_matches_port(tower):
    """ONE call of the Pallas kernel itself (interpret mode, bit-walk form,
    1 env x 2 agents, 24 px) against the port's render_batch. Both sides render
    the live prefix of the box and prop tables (the render bucket), which keeps
    the interpreted kernel's table short."""
    from megaverse_tpu_torch.types import tree_map

    jst, jcfg = tower["jst"], tower["jcfg"]
    up8 = lambda n: max(8, -(-int(n) // 8) * 8)
    mb = up8((np.asarray(jst.box_color[0]) > 0).sum())
    pb = up8((np.asarray(jst.props.type[0]) != C.PROP_NONE).sum())
    one = jax.tree.map(lambda x: x[:1], jst)
    jprims = jax.vmap(lambda s: JRP.build_prim_table(
        jcfg, s.box_lo[:mb], s.box_hi[:mb], s.box_color[:mb],
        jax.tree.map(lambda x: x[:pb], s.props), s.agents))(one)
    jp, jc, (jsl, jcb, jsd, jcd) = _jax_cull(jprims, tower["jcams"][:1])
    want = np.asarray(JRP.render_packed(
        tower["jcams"][:1], jp, H, W, clusters=jc, scbits=jsl, clbits=jcb,
        scdist=jsd, cdist=jcd, interpret=True))
    got = render_batch(tower["tscn"], tree_map(lambda x: x[:1], tower["tst"]),
                       fmt="packed", bucket=(mb, (pb,))).numpy()
    full = render_batch(tower["tscn"], tree_map(lambda x: x[:1], tower["tst"]),
                        fmt="packed").numpy()
    np.testing.assert_array_equal(got, full)     # the bucket changes no pixel
    assert_images_close(got, want)
