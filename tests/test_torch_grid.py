"""Port vs JAX package: packed solid-column grid queries (ops/grid.py).

The same numpy inputs go through megaverse_tpu.ops.grid (unbatched, B added
here with jax.vmap or a leading axis of 1) and megaverse_tpu_torch.ops.grid
(explicit B axis). Integer and boolean results must be EQUAL; float results
agree to atol 1e-6 (both are float32 evaluations of the same expressions;
only elementary functions such as sqrt may differ in the last place).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import megaverse_tpu.constants as C
from megaverse_tpu.ops import grid as JG
from megaverse_tpu.types import GridConfig as JGridConfig
from megaverse_tpu_torch.ops import grid as TG
from megaverse_tpu_torch.types import GridConfig as TGridConfig

import torch_port_checks  # noqa: F401  (one intra-op torch thread)

DIMS = {
    "y8": ((16, 8, 16), (-4.0, -2.0, -4.0)),
    "y32": ((6, 32, 5), (0.0, 0.0, 0.0)),        # top cell lands on bit 31
    "y40": ((12, 40, 12), (-2.0, -3.0, -2.0)),   # second word in use
}
B = 3


def cfgs(key):
    dims, origin = DIMS[key]
    return (JGridConfig(dims=dims, voxel_size=1.0, origin=origin),
            TGridConfig(dims=dims, voxel_size=1.0, origin=origin))


def random_world(key, seed, density=0.3):
    dims, _ = DIMS[key]
    rng = np.random.default_rng(seed)
    vt = (rng.random((B,) + dims) < density).astype(np.uint8) * C.VOXEL_SOLID
    vt[:, :, dims[1] - 1, :] |= (rng.random((B, dims[0], dims[2])) < 0.5).astype(np.uint8)
    return rng, vt


def jax_cols(jcfg, vt):
    return jax.vmap(lambda v: JG.pack_solid_columns(jcfg, v))(jnp.asarray(vt))


def torch_cols(vt):
    return torch.from_numpy(np.stack([TG.pack_solid_columns_np(v) for v in vt]))


def as_u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("key", sorted(DIMS))
def test_pack_solid_columns_matches(key):
    jcfg, tcfg = cfgs(key)
    _, vt = random_world(key, 0)
    want = np.asarray(jax_cols(jcfg, vt))
    np.testing.assert_array_equal(as_u32(torch_cols(vt)), want)
    np.testing.assert_array_equal(
        as_u32(TG.pack_solid_columns(tcfg, torch.from_numpy(vt))), want)
    for b in range(B):
        np.testing.assert_array_equal(
            TG.pack_solid_columns_np(vt[b]).view(np.uint32),
            JG.pack_solid_columns_np(vt[b]))
    if key == "y32":
        assert (want >> 31).any(), "bit 31 must be exercised"


def test_world_to_voxel_and_center():
    jcfg, tcfg = cfgs("y8")
    p = np.random.default_rng(1).uniform(-6, 14, size=(B, 7, 3)).astype(np.float32)
    p[0, 0] = [0.0, 0.0, 0.0]
    p[0, 1] = [-3.5, -1.5, 3.99]
    ji = np.asarray(JG.world_to_voxel(jcfg, jnp.asarray(p)))
    ti = TG.world_to_voxel(tcfg, torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(ti, ji)
    assert tuple(ti[0, 0]) == (4, 2, 4) and tuple(ti[0, 1]) == (0, 0, 7)
    np.testing.assert_allclose(
        TG.voxel_center(tcfg, torch.from_numpy(ji.copy())).numpy(),
        np.asarray(JG.voxel_center(jcfg, jnp.asarray(ji))), atol=1e-6)


@pytest.mark.parametrize("key", sorted(DIMS))
def test_point_queries_match(key):
    """solid_from_cols and gather_voxel incl. out-of-bounds coords."""
    jcfg, tcfg = cfgs(key)
    rng, vt = random_world(key, 2)
    dims = np.asarray(DIMS[key][0])
    ii = rng.integers(-2, dims + 2, size=(B, 64, 3)).astype(np.int32)
    jc, tc = jax_cols(jcfg, vt), torch_cols(vt)
    want = np.asarray(jax.vmap(lambda c, i: JG.solid_from_cols(jcfg, c, i))(jc, jnp.asarray(ii)))
    got = TG.solid_from_cols(tcfg, tc, torch.from_numpy(ii)).numpy()
    np.testing.assert_array_equal(got, want)
    field = rng.integers(0, 90, size=vt.shape).astype(np.int16)
    want = np.asarray(jax.vmap(lambda f, i: JG.gather_voxel(jcfg, f, i))(
        jnp.asarray(field), jnp.asarray(ii)))
    got = TG.gather_voxel(tcfg, torch.from_numpy(field), torch.from_numpy(ii)).numpy()
    np.testing.assert_array_equal(got, want)


def distinct_cells(rng, dims, n):
    raw = np.unique(rng.integers(-2, np.asarray(dims) + 2, size=(n, 3)), axis=0)
    clipped = np.clip(raw, 0, np.asarray(dims) - 1)
    _, first = np.unique(clipped, axis=0, return_index=True)
    return np.concatenate([raw[np.sort(first)], np.full((4, 3), -1)]).astype(np.int32)


@pytest.mark.parametrize("solid", [True, False])
@pytest.mark.parametrize("key", sorted(DIMS))
def test_update_cols_and_set_voxel_match(key, solid):
    """update_cols (incl. bit 31, several bits of one word, dropped rows) and
    set_voxel agree with the JAX package and with re-packing the dense grid."""
    jcfg, tcfg = cfgs(key)
    rng, vt = random_world(key, 3)
    dims = DIMS[key][0]
    cells = [distinct_cells(rng, dims, 80) for _ in range(B)]
    n = min(len(c) for c in cells)
    ii = np.stack([c[-n:] for c in cells])          # keeps the -1 rows
    top = np.asarray([[1, dims[1] - 1, 1], [1, dims[1] - 2, 1]], np.int32)
    ii[:, :2] = top                                   # same word, highest bits
    jc, tc = jax_cols(jcfg, vt), torch_cols(vt)
    want = np.asarray(jax.vmap(lambda c, i: JG.update_cols(jcfg, c, i, solid))(jc, jnp.asarray(ii)))
    # both write into the grid they are given: hand them copies
    got = TG.update_cols(tcfg, tc.clone(), torch.from_numpy(ii), solid)
    np.testing.assert_array_equal(as_u32(got), want)
    # dense twin: set_voxel then re-pack
    flag = np.uint8(C.VOXEL_SOLID if solid else 0)
    tvt = torch.from_numpy(vt.copy())
    cur = TG.gather_voxel(tcfg, tvt, torch.from_numpy(ii))
    tvt2 = TG.set_voxel(tcfg, tvt, torch.from_numpy(ii), (cur & 0xFE) | int(flag))
    np.testing.assert_array_equal(as_u32(TG.pack_solid_columns(tcfg, tvt2)), want)
    jvt2 = jax.vmap(lambda f, i, v: JG.set_voxel(jcfg, f, i, v))(
        jnp.asarray(vt), jnp.asarray(ii), jnp.asarray(((cur & 0xFE) | int(flag)).numpy()))
    np.testing.assert_array_equal(tvt2.numpy(), np.asarray(jvt2))
    # fully masked rows change nothing
    none = torch.full((B, 4, 3), -1, dtype=torch.int32)
    np.testing.assert_array_equal(TG.update_cols(tcfg, tc.clone(), none, True).numpy(),
                                  tc.numpy())


@pytest.mark.parametrize("max_scan", [1, 7, 16, 32])
def test_first_free_above_matches(max_scan):
    jcfg, tcfg = cfgs("y40")
    rng, vt = random_world("y40", 7, density=0.45)
    vt[:, 3, :, 4] = C.VOXEL_SOLID                   # one all-solid column
    ii = np.stack([rng.integers(-2, 14, (B, 128)), rng.integers(-2, 44, (B, 128)),
                   rng.integers(-2, 14, (B, 128))], axis=-1).astype(np.int32)
    jc, tc = jax_cols(jcfg, vt), torch_cols(vt)
    want = np.asarray(jax.vmap(
        lambda c, i: JG.first_free_above(jcfg, c, i, max_scan))(jc, jnp.asarray(ii)))
    got = TG.first_free_above(tcfg, tc, torch.from_numpy(ii), max_scan).numpy()
    np.testing.assert_array_equal(got, want)
    # and against the sequential climb it replaces
    voxel = torch.from_numpy(ii)
    up = torch.tensor([0, 1, 0], dtype=torch.int32)
    for _ in range(max_scan):
        occ = TG.solid_from_cols(tcfg, tc, voxel)
        voxel = torch.where(occ[..., None], voxel + up, voxel)
    np.testing.assert_array_equal(got, voxel.numpy())


def capsule_boxes(key, seed, n=200):
    rng, vt = random_world(key, seed, density=0.15)
    dims, origin = DIMS[key]
    lo_w = np.asarray(origin) - 1.0
    hi_w = np.asarray(origin) + np.asarray(dims) + 1.0
    pos = rng.uniform(lo_w, hi_w, size=(B, n, 3)).astype(np.float32)
    pos[..., 1] = rng.uniform(origin[1] + 1, origin[1] + dims[1] - 1, size=(B, n))
    he = np.array([0.33, 0.855, 0.33], np.float32)
    return vt, pos - he, pos + he, pos


@pytest.mark.parametrize("query", ["aabb", "cell", "floor", "ceiling"])
@pytest.mark.parametrize("key", ["y8", "y40"])
def test_box_queries_match(key, query):
    jcfg, tcfg = cfgs(key)
    vt, lo, hi, pos = capsule_boxes(key, 11)
    jc, tc = jax_cols(jcfg, vt), torch_cols(vt)
    jl, jh, tl, th = jnp.asarray(lo), jnp.asarray(hi), torch.from_numpy(lo), torch.from_numpy(hi)
    if query == "aabb":
        want = jax.vmap(lambda c, a, b: JG.cols_aabb_hits_solid(jcfg, c, a, b, (2, 2)))(jc, jl, jh)
        got = TG.cols_aabb_hits_solid(tcfg, tc, tl, th, (2, 2))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    if query == "cell":
        ix = np.floor(pos[..., 0] - DIMS[key][1][0]).astype(np.int32) + 1
        iz = np.floor(pos[..., 2] - DIMS[key][1][2]).astype(np.int32) - 1
        want = jax.vmap(lambda c, x, z, a, b: JG.cols_cell_solid(jcfg, c, x, z, a, b))(
            jc, jnp.asarray(ix), jnp.asarray(iz), jl[..., 1], jh[..., 1])
        got = TG.cols_cell_solid(tcfg, tc, torch.from_numpy(ix), torch.from_numpy(iz),
                                 tl[..., 1], th[..., 1])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    if query == "floor":
        wy, wf = jax.vmap(lambda c, a, b: JG.cols_highest_floor_below(
            jcfg, c, a[:, 0], b[:, 0], a[:, 2], b[:, 2], a[:, 1], 4.0, (2, 2)))(jc, jl, jh)
        gy, gf = TG.cols_highest_floor_below(
            tcfg, tc, tl[..., 0], th[..., 0], tl[..., 2], th[..., 2], tl[..., 1], 4.0, (2, 2))
    else:
        wy, wf = jax.vmap(lambda c, a, b: JG.cols_lowest_ceiling_above(
            jcfg, c, a[:, 0], b[:, 0], a[:, 2], b[:, 2], b[:, 1], 2.0, (2, 2)))(jc, jl, jh)
        gy, gf = TG.cols_lowest_ceiling_above(
            tcfg, tc, tl[..., 0], th[..., 0], tl[..., 2], th[..., 2], th[..., 1], 2.0, (2, 2))
    np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))
    assert np.asarray(wf).any() and not np.asarray(wf).all()
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), atol=1e-6)


@pytest.mark.parametrize("which", ["floor", "ceiling"])
@pytest.mark.parametrize("key", ["y8", "y40"])
def test_capsule_scans_match(key, which):
    jcfg, tcfg = cfgs(key)
    vt, lo, hi, pos = capsule_boxes(key, 13)
    jc, tc = jax_cols(jcfg, vt), torch_cols(vt)
    cx, cz = pos[..., 0], pos[..., 2]
    if which == "floor":
        wy, wf = jax.vmap(lambda c, x, z, y: JG.cols_capsule_floor_below(
            jcfg, c, x, z, y, 4.0, (2, 2), 0.33))(jc, jnp.asarray(cx), jnp.asarray(cz),
                                                   jnp.asarray(lo[..., 1]))
        gy, gf = TG.cols_capsule_floor_below(
            tcfg, tc, torch.from_numpy(cx), torch.from_numpy(cz),
            torch.from_numpy(lo[..., 1]), 4.0, (2, 2), 0.33)
    else:
        wy, wf = jax.vmap(lambda c, x, z, y: JG.cols_capsule_ceiling_above(
            jcfg, c, x, z, y, 2.0, (2, 2), 0.33))(jc, jnp.asarray(cx), jnp.asarray(cz),
                                                   jnp.asarray(hi[..., 1]))
        gy, gf = TG.cols_capsule_ceiling_above(
            tcfg, tc, torch.from_numpy(cx), torch.from_numpy(cz),
            torch.from_numpy(hi[..., 1]), 2.0, (2, 2), 0.33)
    np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))
    assert np.asarray(wf).any() and not np.asarray(wf).all()
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), atol=1e-6)


def test_capsule_floor_edge_dip_and_slip():
    """Support under the axis equals the cell top; at distance d from a ledge
    edge it dips by r - sqrt(r^2 - d^2); past d = r*sin(45deg) there is none."""
    r = 0.33
    cfg = TGridConfig(dims=(16, 8, 16), voxel_size=1.0, origin=(-8.0, -2.0, -8.0))
    vt = np.zeros((1,) + cfg.dims, np.uint8)
    vt[0, :, 1, :8] = C.VOXEL_SOLID          # floor top y=0 for z < 0
    cols = TG.pack_solid_columns(cfg, torch.from_numpy(vt))

    def support(cx, cz, bottom=0.0):
        t = lambda v: torch.tensor([[v]], dtype=torch.float32)
        y, f = TG.cols_capsule_floor_below(cfg, cols, t(cx), t(cz), t(bottom), 4.0, (2, 2), r)
        return float(y[0, 0]), bool(f[0, 0])

    y, f = support(0.5, -2.0)
    assert f and y == 0.0
    d = 0.12
    y, f = support(0.5, d)
    assert f
    np.testing.assert_allclose(y, -(r - np.sqrt(r * r - d * d)), atol=1e-6)
    y, f = support(0.5, r * np.sin(np.pi / 4) + 0.01)
    assert not f
