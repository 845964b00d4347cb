"""The alternate forms of the render kernel (B3 clustered, B4 sorted lists, B5
superclusters, B6 merged tiles) and their prologues, port vs JAX package on
the CPU.

On the CPU `render_packed` takes each form's plain PyTorch version, which is
what these tests exercise; the CUDA kernel forms are held against B1 and
against these plain versions on the card by chip_smoke.py.

Two scenes, 24 px high (3 tile rows): a Collect state (2 envs x 2 agents)
after 3 random steps, rendered through its bucket, and the synthetic table
with rows of every type (reward indicators on).
  * `sort_clusters` / `frustum_cull` against the JAX functions on the same
    cams and cluster tables: `dist` to rtol/atol 1e-6; `order` equal, except
    that where two keys lie within 1e-6 of each other either order of the pair
    is accepted (XLA's and PyTorch's sorts may break such a tie differently):
    `order` must then still be a permutation whose keys ascend;
  * every plain form, tiled and merged, EXACTLY equal to the port's plain B1;
  * the port's B1 against ONE image of the JAX package per scene (its rolled
    table renderer; the JAX package's own tests hold its six kernel forms
    identical to that in interpret mode): at most 1 per colour channel on
    fewer than 1e-4 of the pixels, outside the few pixels (at most 16 of the
    12,288 of a scene) where the port's own float32 arithmetic is
    ill-conditioned, i.e. where the same expressions in float64 give another
    colour (grazing hits on the cones of Collect's diamonds); on those the JAX
    image must be within 8 per channel of the port's float32 colour (observed:
    9 such pixels, 6 at most; the three evaluations give three nearby shades
    of the same surface);
  * `render_tables` under each setting of the environment variables picks the
    form that megaverse_tpu/env.py render_batch picks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import megaverse_tpu.constants as C
from megaverse_tpu.ops import raycast as JR
from megaverse_tpu.ops import raycast_pallas as JRP
from megaverse_tpu.scenarios import make_scenario as j_make_scenario
from megaverse_tpu.types import AgentState as JAgentState

from megaverse_tpu_torch import VectorEnv as TVectorEnv
from megaverse_tpu_torch.env import UNCULLED, RenderMode, render_batch, render_tables
from megaverse_tpu_torch.ops import raycast as TR
from megaverse_tpu_torch.ops import raycast_cuda as TRC
from megaverse_tpu_torch.utils.synthetic import form_tables, synthetic_cams, synthetic_prims

import torch_port_checks  # noqa: F401  (one intra-op torch thread)

H, W = 24, 128
CAM_OFF = np.float32(C.AGENT_BODY_OFFSET_Y + C.AGENT_CAMERA_OFFSET_Y)
CASES = ["b3", "b4_agent", "b4_agent_dist", "b4_tile", "b4_shuffled", "b5"]


@pytest.fixture(scope="module")
def collect_env():
    env = TVectorEnv("Collect", num_envs=2, num_agents_per_env=2, seed=5, render=False,
                     device="cpu")
    env.scenario.cfg = dataclasses.replace(env.scenario.cfg, obs_height=H)
    env.reset()
    rng = np.random.default_rng(1)
    for _ in range(3):
        env.step(rng.integers(0, 2048, size=(2, 2)).astype(np.int32))
    yield env
    env.close()


@pytest.fixture(scope="module")
def scenes(collect_env):
    """name -> dict(cams, prims, ui, b1 image, tables per case, agent pos)."""
    out = {}
    env = collect_env
    tabs = render_tables(env.scenario, env.state, bucket=env._bucket, mode=UNCULLED)
    out["collect"] = dict(cams=tabs["cams"], prims=tabs["prims"], ui=False,
                          pos=env.state.agents.pos.numpy())
    prims = synthetic_prims(seed=3, num_envs=2)
    cams = synthetic_cams(seed=3, prims=prims, num_agents=2)
    # eye = agent pos + camera offset in both packages: make that sum exact
    pos = cams[..., :3].copy()
    pos[..., 1] -= CAM_OFF
    cams[..., :3] = pos
    cams[..., 1] += CAM_OFF
    out["synthetic"] = dict(cams=torch.from_numpy(cams), prims=torch.from_numpy(prims),
                            ui=True, pos=pos)
    for sc in out.values():
        sc["b1"] = TRC.render_packed(sc["cams"], sc["prims"], H, W, ui_indicators=sc["ui"])
        sc["tables"] = form_tables(sc["cams"], sc["prims"], H, W, seed=1)
    return out


# ---------------------------------------------------------------------------
# Prologues against the JAX functions.
# ---------------------------------------------------------------------------

def assert_lists_match(t_order, t_dist, j_order, j_dist):
    t_order, t_dist = t_order.numpy(), t_dist.numpy()
    j_order, j_dist = np.asarray(j_order), np.asarray(j_dist)
    assert t_order.dtype == np.int32 and t_dist.dtype == np.float32
    assert t_order.shape == j_order.shape and t_dist.shape == j_dist.shape
    finite = np.isfinite(j_dist)
    np.testing.assert_array_equal(np.isfinite(t_dist), finite)
    np.testing.assert_allclose(t_dist[finite], j_dist[finite], rtol=1e-6, atol=1e-6)
    n = t_order.shape[-1]
    same = (t_order == j_order).all(axis=-1)
    for idx in np.argwhere(~same):
        to, jo = t_order[tuple(idx)], j_order[tuple(idx)]
        td, jd = t_dist[tuple(idx)], j_dist[tuple(idx)]
        assert sorted(to.tolist()) == list(range(n)), "order must be a permutation"
        assert (np.diff(td[np.isfinite(td)]) >= 0).all(), "keys must ascend"
        key = np.empty(n, np.float64)
        key[jo] = jd                        # the JAX key of every cluster
        ok = np.isclose(key[to], jd, rtol=1e-6, atol=1e-6) | (np.isinf(key[to]) & np.isinf(jd))
        assert ok.all(), "orders may differ only between (nearly) equal keys"
    return int((~same).sum())


@pytest.mark.parametrize("scene", ["collect", "synthetic"])
def test_sort_clusters_matches_jax(scenes, scene):
    sc = scenes[scene]
    clusters = sc["tables"]["b3"]["clusters"]
    t_order, t_dist = TRC.sort_clusters(sc["cams"], clusters)
    j_order, j_dist = JRP.sort_clusters(jnp.asarray(sc["cams"].numpy()),
                                        jnp.asarray(clusters.numpy()))
    assert_lists_match(t_order, t_dist, j_order, j_dist)
    assert t_order.shape == (2, 2, clusters.shape[1])
    # dead clusters (point box at +INF) sort last
    dead = (clusters[..., 0] > 1e29).sum(dim=1)
    for b in range(2):
        if dead[b]:
            tail = t_order[b, :, -int(dead[b]):].long()
            assert (clusters[b][tail][..., 0] > 1e29).all()


@pytest.mark.parametrize("level", ["clusters", "superclusters"])
@pytest.mark.parametrize("scene", ["collect", "synthetic"])
def test_frustum_cull_matches_jax(scenes, scene, level):
    sc = scenes[scene]
    table = (sc["tables"]["b3"]["clusters"] if level == "clusters"
             else sc["tables"]["b5"]["sclusters"])
    t_order, t_dist = TRC.frustum_cull(sc["cams"], table, H, W)
    j_order, j_dist = JRP.frustum_cull(jnp.asarray(sc["cams"].numpy()),
                                       jnp.asarray(table.numpy()), H, W)
    assert_lists_match(t_order, t_dist, j_order, j_dist)
    assert t_order.shape == (2, 2, H // 8, table.shape[1])
    # culled entries carry sqrt(1e30) = 1e15 (only a dead box that no axis of
    # a tile constrains keeps its own +inf); real culling happens
    assert float(t_dist[torch.isfinite(t_dist)].max()) <= 1.0001e15
    if scene == "collect" and level == "clusters":
        assert (t_dist > 1e14).any() and (t_dist < 1e14).any()


def test_superclusters_match_jax(scenes):
    clusters = scenes["collect"]["tables"]["b3"]["clusters"]
    tc, ts = TRC.build_superclusters(clusters)
    jc, js = jax.vmap(JRP.build_superclusters)(jnp.asarray(clusters.numpy()))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    assert tc.shape[1] % 4 == 0 and ts.shape[1] * 4 == tc.shape[1]


# ---------------------------------------------------------------------------
# Every plain form equals plain B1.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("merged", [False, True], ids=["tiled", "merged"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("scene", ["collect", "synthetic"])
def test_plain_form_equals_plain_b1(scenes, scene, case, merged):
    sc = scenes[scene]
    img = TRC.render_packed(sc["cams"], height=H, width=W, ui_indicators=sc["ui"],
                            merge_tiles=merged, **sc["tables"][case])
    assert img.dtype == torch.int32 and torch.equal(img, sc["b1"])


@pytest.mark.parametrize("scene", ["collect", "synthetic"])
def test_b1_merged_and_bitwalk_merged_equal_b1(scenes, scene):
    sc = scenes[scene]
    merged = TRC.render_packed(sc["cams"], sc["prims"], H, W, ui_indicators=sc["ui"],
                               merge_tiles=True)
    assert torch.equal(merged, sc["b1"])
    b6 = TRC.render_packed(sc["cams"], height=H, width=W, ui_indicators=sc["ui"],
                           merge_tiles=True, **sc["tables"]["b2"])
    assert torch.equal(b6, sc["b1"])


def test_scenes_exercise_the_forms(scenes):
    """The equalities above are not vacuous: the Collect table is long and has
    dead clusters, its B5 prim table is not padded to whole superclusters, the
    lists cull, and a form that ignores its tables' verdict would differ."""
    col, syn = scenes["collect"], scenes["synthetic"]
    assert len(torch.unique(col["b1"])) > 50 and len(torch.unique(syn["b1"])) > 100
    b5 = col["tables"]["b5"]
    assert b5["clusters"].shape[1] >= 8
    assert any(sc["tables"]["b5"]["prims"].shape[1] < 8 * sc["tables"]["b5"]["clusters"].shape[1]
               for sc in (col, syn)), "no B5 case with an unpadded prim table"
    clusters = col["tables"]["b3"]["clusters"]
    assert (clusters[..., 0] > 1e29).any(), "no dead cluster in the Collect table"
    # dropping the nearest half of each per-agent list changes the image
    t = col["tables"]["b4_agent_dist"]
    half = t["order"].shape[-1] // 2
    far_only = dict(t, dist=torch.cat([torch.full_like(t["dist"][..., :half], 1e15),
                                       t["dist"][..., half:]], dim=-1))
    wrong = TRC.render_packed(col["cams"], height=H, width=W, **far_only)
    assert not torch.equal(wrong, col["b1"])


def test_form_selection_and_argument_checks(scenes):
    sc = scenes["synthetic"]
    t = sc["tables"]
    assert TRC.select_form() == (1, "render_b1")
    assert TRC.select_form(**{k: v for k, v in t["b3"].items() if k != "prims"}) == (3, "render_b3")
    assert TRC.select_form(clusters=1, order=1) == (4, "render_b4")
    assert TRC.select_form(clusters=1, order=1, dist=1, sclusters=1) == (5, "render_b5")
    assert TRC.select_form(clusters=1, sclist=1) == (2, "render_b2")
    assert TRC.select_form(clusters=1, sclist=1, merge_tiles=True) == (2, "render_b6")
    assert TRC.select_form(merge_tiles=True) == (1, "render_b6")
    before = dict(TRC.LAUNCHES)
    TRC.render_packed(sc["cams"], height=H, width=W, **t["b5"])
    assert TRC.LAUNCHES == before and set(before) == {*TRC.FORMS, "masked_copy", "kcc",
                                                     "stacking"}


# ---------------------------------------------------------------------------
# The port's B1 against one JAX image per scene.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scene", ["collect", "synthetic"])
def test_b1_matches_jax_image(scenes, scene):
    sc = scenes[scene]
    cfg = j_make_scenario("Empty", num_agents=2, params={
        C.P_USE_UI_REWARD_INDICATORS: 1.0 if sc["ui"] else 0.0}).cfg
    cfg = dataclasses.replace(cfg, obs_height=H)

    def one(p, cam, ps):
        agents = JAgentState.create(ps.shape[0]).replace(pos=ps, yaw=cam[:, 3], pitch=cam[:, 4])
        return JR.render_table_packed(cfg, agents, p, cam[:, 5], last_reward=cam[:, 6])

    want = np.asarray(jax.jit(jax.vmap(one))(
        jnp.asarray(sc["prims"].numpy()), jnp.asarray(sc["cams"].numpy()),
        jnp.asarray(sc["pos"])))
    got = sc["b1"].numpy()
    unpack = lambda p: np.stack([(p >> 16) & 0xFF, (p >> 8) & 0xFF, p & 0xFF], -1).astype(np.int64)
    delta = np.abs(unpack(got) - unpack(want))
    # Pixels where the port's own arithmetic is ill-conditioned in float32 (the
    # same expression tree evaluated in float64 gives another colour: grazing
    # hits on the diamonds' cones, whose normal goes through rsqrt and x**300)
    # are set aside; they must be few, and there the JAX colour is a nearby
    # shade of the same surface. Everywhere else the two packages agree to 1
    # per channel on fewer than 1e-4 of the pixels.
    img64 = TR.render_table_packed(sc["cams"].double(), sc["prims"].double(), H, W, sc["ui"])
    sensitive = (unpack(got) != unpack(img64.numpy())).any(-1)
    assert sensitive.sum() <= 16
    assert (delta[sensitive] <= 8).all(), f"set-aside pixels: max delta {delta[sensitive].max()}"
    assert (delta[~sensitive] <= 1).all(), f"max channel delta {delta[~sensitive].max()}"
    assert (delta[~sensitive] != 0).any(-1).mean() < 1e-4


# ---------------------------------------------------------------------------
# Mode selection (megaverse_tpu/env.py render_batch, the `pallas` branch).
# ---------------------------------------------------------------------------

MODES = [
    # environment, counter, expected keys beyond cams/prims/ui/merge, order.ndim, dist?
    ({}, "render_b2", {"clusters", "sclist", "clbits", "scdist", "cdist"}, None),
    ({"MEGAVERSE_NO_CLUSTER_CULL": "1"}, "render_b1", set(), None),
    ({"MEGAVERSE_RENDER_MODE": "super", "MEGAVERSE_NO_CLUSTER_CULL": "1"}, "render_b1",
     set(), None),
    ({"MEGAVERSE_RENDER_MODE": "super"}, "render_b5",
     {"clusters", "sclusters", "order", "dist"}, 4),
    ({"MEGAVERSE_RENDER_MODE": "super", "MEGAVERSE_NO_SUPERCLUSTERS": "1"}, "render_b4",
     {"clusters", "order", "dist"}, 4),
    ({"MEGAVERSE_RENDER_MODE": "super", "MEGAVERSE_NO_TILE_CULL": "1"}, "render_b4",
     {"clusters", "order", "dist"}, 3),
    ({"MEGAVERSE_RENDER_MODE": "super", "MEGAVERSE_NO_EARLY_EXIT": "1"}, "render_b4",
     {"clusters", "order"}, 3),
    ({"MEGAVERSE_RENDER_MODE": "super", "MEGAVERSE_NO_CLUSTER_SORT": "1"}, "render_b3",
     {"clusters"}, None),
    ({"MEGAVERSE_RENDER_MODE": "super", "MEGAVERSE_NO_CLUSTER_SORT": "1",
      "MEGAVERSE_NO_TILE_CULL": "1"}, "render_b3", {"clusters"}, None),
    ({"MEGAVERSE_MERGE_TILES": "1"}, "render_b6",
     {"clusters", "sclist", "clbits", "scdist", "cdist"}, None),
    ({"MEGAVERSE_RENDER_MODE": "super", "MEGAVERSE_MERGE_TILES": "1"}, "render_b6",
     {"clusters", "sclusters", "order", "dist"}, 4),
]
ALL_VARS = ("MEGAVERSE_RENDER_MODE", "MEGAVERSE_NO_CLUSTER_CULL", "MEGAVERSE_NO_CLUSTER_SORT",
            "MEGAVERSE_NO_TILE_CULL", "MEGAVERSE_NO_EARLY_EXIT", "MEGAVERSE_NO_SUPERCLUSTERS",
            "MEGAVERSE_MERGE_TILES")


def set_env(monkeypatch, env):
    for k in ALL_VARS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("env,counter,keys,ndim", MODES,
                         ids=["+".join(f"{k[10:]}={v}" for k, v in m[0].items()) or "default"
                              for m in MODES])
def test_render_tables_picks_the_reference_form(monkeypatch, collect_env, scenes,
                                                env, counter, keys, ndim):
    set_env(monkeypatch, env)
    scn, st, bucket = collect_env.scenario, collect_env.state, collect_env._bucket
    tabs = render_tables(scn, st, bucket=bucket)        # mode read from the environment
    present = {k for k, v in tabs.items() if v is not None} - {
        "cams", "prims", "ui_indicators", "merge_tiles"}
    assert present == keys
    names = ("clusters", "order", "dist", "sclusters", "sclist", "merge_tiles")
    assert TRC.select_form(**{k: tabs.get(k) for k in names})[1] == counter
    assert tabs["merge_tiles"] == bool(env.get("MEGAVERSE_MERGE_TILES"))
    if ndim is not None:
        assert tabs["order"].dim() == ndim
    m8 = -(-scenes["collect"]["prims"].shape[1] // 8) * 8
    if "sclusters" in keys:
        # only the cluster table is padded to whole superclusters
        assert tabs["prims"].shape[1] == m8 and tabs["clusters"].shape[1] % 4 == 0
        assert tabs["order"].shape[-1] == tabs["sclusters"].shape[1]
    elif "sclist" in keys:
        assert tabs["prims"].shape[1] == 8 * tabs["clusters"].shape[1]
    elif keys:
        assert tabs["prims"].shape[1] == m8 == 8 * tabs["clusters"].shape[1]
    img = render_batch(scn, st, fmt="packed", bucket=bucket)
    assert torch.equal(img, scenes["collect"]["b1"])


def test_short_tables_take_per_tile_cluster_lists(monkeypatch):
    """clusters.shape[1] < 2 * SUPER_K: no superclusters (Empty has one cluster);
    and VectorEnv reads the environment once, at construction."""
    set_env(monkeypatch, {"MEGAVERSE_RENDER_MODE": "super"})
    env = TVectorEnv("Empty", num_envs=2, num_agents_per_env=2, seed=3, device="cpu",
                     obs_format="packed")
    env.scenario.cfg = dataclasses.replace(env.scenario.cfg, obs_height=H)
    set_env(monkeypatch, {})
    assert env.render_mode == RenderMode(mode="super")
    obs = env.reset()
    tabs = render_tables(env.scenario, env.state, bucket=env._bucket, mode=env.render_mode)
    assert tabs["clusters"].shape[1] < 8 and "sclusters" not in tabs
    assert tabs["order"].dim() == 4 and tabs["dist"] is not None
    default = render_batch(env.scenario, env.state, fmt="packed", bucket=env._bucket)
    assert RenderMode.from_env() == RenderMode() and torch.equal(obs, default)
    env.close()
