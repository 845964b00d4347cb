"""The port's profilers on the CPU: scripts/profile_train_step_torch.py,
scripts/profile_culling_torch.py and scripts/analyze_culling_torch.py (the
twins of scripts/profile_train_step.py, profile_culling.py and
analyze_culling.py).

The culling twins count on the port's own tables; here their counts on a
Collect state (2 envs x 2 agents after 3 random steps, 24 px) must EQUAL the
counts of the JAX package's tables for the same state, counted the way the
JAX scripts count (their loop is repeated below; `ray_dirs` and `slab` are
imported from scripts/analyze_culling.py). The JAX tables come from one
jitted function: the file's one JAX compile.
"""

import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import megaverse_tpu.constants as JC
from megaverse_tpu.ops import raycast_pallas as JRP
from megaverse_tpu.scenarios import make_scenario as j_make_scenario
from megaverse_tpu.types import AgentState as JAgentState, PropState as JPropState

from megaverse_tpu_torch import convert

import torch_port_checks  # noqa: F401  (one torch thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = 24


def script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts",
                                                                     name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def collect():
    """The port's Collect state and the JAX package's tables of it."""
    A = script("analyze_culling_torch")
    env = A.random_state("Collect", 2, 2, seed=3, steps=3, device="cpu")
    env.close()
    env.scenario.cfg = dataclasses.replace(env.scenario.cfg, obs_height=H)
    st = convert.tree_to_numpy(env.state)
    jcfg = dataclasses.replace(j_make_scenario("Collect", num_agents=2).cfg, obs_height=H)
    w = jcfg.obs_width

    @jax.jit
    def tables(box_lo, box_hi, box_color, props, agents, ep_len, ep_sec):
        remaining = jnp.maximum(0.0, (ep_len - ep_sec) / ep_len)
        cams = jax.vmap(lambda a, tf: JRP.build_cams(jcfg, a, tf))(agents, remaining)
        prims = jax.vmap(lambda lo, hi, col, p, a: JRP.build_prim_table(
            jcfg, lo, hi, col, p, a, include_agent_rows=True))(
            box_lo, box_hi, box_color, props, agents)
        prims_c, clusters = jax.vmap(JRP.build_clusters)(prims)
        _, dist = JRP.frustum_cull(cams, clusters, H, w)
        clusters2, sclusters = jax.vmap(JRP.build_superclusters)(clusters)
        prims2 = jax.vmap(JRP.pad_prims_to_clusters)(prims_c, clusters2)
        _, clbits, _, cdist = JRP.cull_bits(cams, clusters2, H, w)
        return dict(prims=prims, clusters=clusters, dist=dist, prims2=prims2,
                    clusters2=clusters2, sclusters=sclusters, clbits=clbits, cdist=cdist)

    j = lambda tree: {k: jnp.asarray(v) for k, v in tree.items()}
    jt = tables(jnp.asarray(st["box_lo"]), jnp.asarray(st["box_hi"]),
                jnp.asarray(st["box_color"]), JPropState(**j(st["props"])),
                JAgentState(**j(st["agents"])), jnp.asarray(st["episode_len_sec"]),
                jnp.asarray(st["episode_sec"]))
    return dict(env=env, st=st, jt={k: np.asarray(v) for k, v in jt.items()}, w=w)


def jax_script_stages(jt, st, h, w):
    """scripts/analyze_culling.py's loop on the JAX tables: per (env, agent,
    tile) survivors of each stage, and each (env, agent, tile)'s depth bound."""
    AJ = script("analyze_culling")
    prims, clusters, sclusters = jt["prims2"], jt["clusters2"], jt["sclusters"]
    pos, yaw, pitch = (st["agents"][k] for k in ("pos", "yaw", "pitch"))
    G = clusters.shape[1]
    live = prims[..., 0] >= 0
    TH = 8
    stats = {k: [] for k in ["sc_frustum", "cl_frustum", "rows_frustum", "sc_final",
                             "cl_final", "rows_final", "rows_visible", "bound"]}
    for b in range(prims.shape[0]):
        for a in range(pos.shape[1]):
            eye = pos[b, a] + np.array([0.0, JC.AGENT_BODY_OFFSET_Y + JC.AGENT_CAMERA_OFFSET_Y,
                                        0.0])
            dr = AJ.ray_dirs(h, w, yaw[b, a], pitch[b, a], JC.CAMERA_FOV_DEG).reshape(-1, 3)
            tmin_c, tmax_c = AJ.slab(eye, dr, clusters[b, :, 0:3], clusters[b, :, 3:6])
            tmin_s, tmax_s = AJ.slab(eye, dr, sclusters[b, :, 0:3], sclusters[b, :, 3:6])
            box = prims[b, :, 0] == 0
            tmin_r, tmax_r = AJ.slab(eye, dr, prims[b, box, 1:4], prims[b, box, 4:7])
            hit = (tmax_r >= tmin_r) & (tmin_r > JC.CAMERA_NEAR)
            t = np.where(hit, tmin_r, np.inf)
            depth = np.minimum(t.min(1).reshape(h, w), JC.CAMERA_FAR)
            for ti in range(h // TH):
                sl = slice(ti * TH * w, (ti + 1) * TH * w)
                dtile = depth[ti * TH:(ti + 1) * TH].max() + 0.01
                stats["bound"].append(dtile)

                def reach(tmin, tmax, bound):
                    return ((tmax[sl] >= tmin[sl]) & (tmax[sl] > 0)
                            & (tmin[sl] < bound)).any(0)

                for stage, bound in (("frustum", JC.CAMERA_FAR), ("final", dtile)):
                    scr, clr = reach(tmin_s, tmax_s, bound), reach(tmin_c, tmax_c, bound)
                    stats[f"sc_{stage}"].append(scr.sum())
                    stats[f"cl_{stage}"].append(clr.sum())
                    stats[f"rows_{stage}"].append(
                        (clr.reshape(-1)[:, None] & live[b].reshape(G, -1)).sum())
                vis = (t[sl] <= depth[ti * TH:(ti + 1) * TH].reshape(-1, 1) + 1e-6).any(0)
                stats["rows_visible"].append(vis.sum())
    shape = (prims.shape[0], pos.shape[1], h // TH)
    return {k: np.asarray(v).reshape(shape) for k, v in stats.items()}


def test_profile_culling_counts_equal_jax_tables(collect):
    P = script("profile_culling_torch")
    env, jt = collect["env"], collect["jt"]
    got = P.cull_counts(env.scenario, env.state)
    # scripts/profile_culling.py's counts
    np.testing.assert_array_equal(got["live"], (jt["prims"][:, :, 0] >= 0).sum(axis=1))
    assert got["clusters"] == jt["clusters"].shape[1]
    np.testing.assert_array_equal(got["survivors"], (jt["dist"] < 1e7).sum(axis=-1))
    assert got["survivors"].shape == (2, 2, H // 8) and got["survivors"].max() > 0
    # B2's cull and its early exit given the final depths, from JAX's cull_bits
    g2 = jt["clusters2"].shape[1]
    words = jt["clbits"].view(np.uint32)
    keep = ((words[..., :, None] >> np.arange(32, dtype=np.uint32)) & 1).astype(bool)
    keep = keep.reshape(words.shape[:-1] + (-1,))[..., :g2]
    np.testing.assert_array_equal(got["keep_all"], keep.all(-1))
    keep &= (jt["clusters2"][:, None, None, :, 0] < 1e29)     # clusters with a live row
    bound = jax_script_stages(jt, collect["st"], H, collect["w"])["bound"]
    near = jt["cdist"][:, :, None, :] <= bound[..., None]
    np.testing.assert_array_equal(got["b2_survivors"], keep.sum(-1))
    np.testing.assert_array_equal(got["b2_visits"], (keep & near).sum(-1))
    assert (got["b2_visits"] <= got["b2_survivors"]).all()


def test_analyze_culling_stages_equal_jax_tables(collect):
    A = script("analyze_culling_torch")
    env, jt = collect["env"], collect["jt"]
    got = A.stage_counts(env.scenario, env.state)
    want = jax_script_stages(jt, collect["st"], H, collect["w"])
    assert got["rows"] == jt["prims2"].shape[1]
    assert (got["clusters"], got["superclusters"]) == (jt["clusters2"].shape[1],
                                                      jt["sclusters"].shape[1])
    for k in A.STAGES:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["cl_frustum"].max() > 0 and got["rows_visible"].max() > 0
    assert (got["cl_final"] <= got["cl_frustum"]).all()


@pytest.mark.parametrize("name,argv,keys", [
    ("profile_culling_torch", ["--scenario", "HexMemory", "--steps", "2"],
     ["survivors", "b2_survivors", "b2_visits"]),
    ("analyze_culling_torch", ["--scenario", "Collect"], ["sc_frustum", "rows_visible"]),
])
def test_culling_scripts_print_their_counts(name, argv, keys, capsys):
    assert script(name).main(argv + ["--num_envs", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    res = json.loads(out[-1])
    for k in keys:
        assert set(res[k]) == {"mean", "p50", "p90", "max"}
    assert res["gpu"] == "cpu"


def test_profile_train_step_prints_every_part(capsys):
    P = script("profile_train_step_torch")
    assert P.main(["--num_envs", "2", "--rollout", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    for part in P.PARTS:
        assert any(line.startswith(part + " ") for line in out), part
    res = json.loads(out[-1])
    assert set(res["ms"]) == set(P.PARTS) and all(v > 0 for v in res["ms"].values())
    assert res["train_env_steps_per_s"] > 0 and res["sampling_env_steps_per_s"] > 0
    assert 0 < res["update_share"] < 1
