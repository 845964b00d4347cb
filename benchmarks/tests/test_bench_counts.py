"""The yardsticks' arithmetic on the CPU: the APPO configuration's FLOPs
against a hand count, the render roofline's count against brute force, the
statistics of the end-to-end and idle metrics on synthetic inputs."""

import math

import numpy as np
import pytest
import torch

import harness as H
from reference import flops, roofline
from reference.sim.ops import raycast as R

CFG = H.load_json(H.BENCH_DIR / "configs" / "appo_convnet_simple_512.json")


def test_forward_flops_match_the_hand_count():
    # convs: 17x31x32 x 3*8*8, 7x14x64 x 32*4*4, 3x6x128 x 64*3*3 multiply-adds;
    # FC 2,304 x 512; two GRU layers of six 512 x 512 products; heads 512 x 17
    conv = 17 * 31 * 32 * 192 + 7 * 14 * 64 * 512 + 3 * 6 * 128 * 576
    assert conv == 7_776_256
    hand = 2 * (conv + 2304 * 512 + 2 * 6 * 512 * 512 + 512 * 17)
    assert flops.forward_flops(CFG) == hand == 24_220_672
    # rollout forward, update forward, update backward (twice the forward,
    # less the first convolution's input gradient: its multiply-adds once)
    assert flops.train_flops(CFG, 1) == hand + hand + 2 * hand - 2 * (17 * 31 * 32 * 192)


def _toy(n_rows=6):
    """Two envs, one camera each, a table of boxes and one ellipsoid row."""
    g = torch.Generator().manual_seed(3)
    b = 2
    prims = torch.zeros((b, n_rows, 12))
    lo = torch.rand((b, n_rows, 3), generator=g) * 6.0 - 3.0
    lo[..., 2] -= 6.0
    prims[:, :, 1:4] = lo
    prims[:, :, 4:7] = lo + 0.5 + torch.rand((b, n_rows, 3), generator=g)
    prims[:, -1, 0] = R.PRIM_ELLIPSOID
    prims[:, -1, 1:4] = torch.tensor([0.0, 0.0, -5.0])
    prims[:, -1, 4:7] = torch.tensor([1.0, 1.5, 1.0])
    cams = torch.zeros((b, 1, 8))
    cams[:, 0, 3] = torch.tensor([0.0, 0.3])
    cams[:, 0, 5] = 1.0
    return cams, prims


def _brute(cams, prims, h, w):
    """Per pixel and row, the same rule in plain Python over numpy rows."""
    from reference.sim.env import row_bounds

    rays, t_hit, *_ = R.trace_table(cams, prims, h, w)
    lo, hi = (x.numpy() for x in row_bounds(prims))
    o = np.stack([x.expand_as(rays.dx).numpy() for x in (rays.ox, rays.oy, rays.oz)], -1)
    inv = np.stack([x.numpy() for x in (rays.ix, rays.iy, rays.iz)], -1)
    stop = np.minimum(t_hit.numpy(), R.FAR)
    box = other = 0
    for bi in range(prims.shape[0]):
        for m in range(prims.shape[1]):
            if prims[bi, m, 0] < 0:
                continue
            t1 = (lo[bi, m] - o[bi]) * inv[bi]
            t2 = (hi[bi, m] - o[bi]) * inv[bi]
            tmin = np.minimum(t1, t2).max(-1)
            tmax = np.maximum(t1, t2).min(-1)
            n = int(((tmax >= np.maximum(tmin, 0)) & (tmin <= stop[bi])).sum())
            if prims[bi, m, 0] == R.PRIM_AABB:
                box += n
            else:
                other += n
    return box, other


def test_roofline_count_matches_brute_force():
    cams, prims = _toy()
    got = roofline.row_tests(cams, prims, 8, 16, rows_per_pass=4)
    assert got == _brute(cams, prims, 8, 16)
    assert got[0] > 0 and got[1] > 0


def test_roofline_count_ignores_row_order_and_dead_rows():
    cams, prims = _toy()
    base = roofline.row_tests(cams, prims, 8, 16)
    perm = torch.randperm(prims.shape[1], generator=torch.Generator().manual_seed(1))
    dead = torch.zeros((2, 5, 12))
    dead[:, :, 0] = -1.0
    dead[:, :, 1:7] = 1.0
    padded = torch.cat([prims[:, perm], dead], dim=1)
    assert roofline.row_tests(cams, padded, 8, 16) == base


def test_chunk_p95_by_nearest_rank():
    times = list(range(1, 201))
    assert H.percentile(times, 95) == 190
    assert sum(t > H.percentile(times, 95) for t in times) == 10
    assert H.percentile([5.0], 95) == 5.0


def test_idle_share_and_gaps():
    kernels = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (7.0, 8.0)]
    assert H.merged_busy(kernels) == 4.0
    assert H.idle_share(4.0, 10.0) == pytest.approx(60.0)
    labels = [(2.0, 3.5, "bench.read"), (0.0, 10.0, "bench.chunk")]
    gaps = H.idle_gaps(kernels, labels, (0.0, 10.0), top=2)
    assert gaps == [["bench.chunk", 3.0], ["bench.chunk", 2.0]]
    assert H.idle_gaps(kernels, labels, (0.0, 10.0))[2] == ["bench.read", 1.0]


def test_trace_summary_reads_kernels_and_calls():
    tr = H.TraceSummary([("render_kernel<2>", 0.0, 0.002), ("add", 0.002, 0.003)],
                        {"cudaGraphLaunch": 2}, [], (0.0, 0.004))
    assert tr.busy_s == pytest.approx(0.003)
    assert tr.kernel_seconds(lambda n: "render_kernel" in n) == pytest.approx(0.002)
    assert tr.kernel_count() == 2 and tr.host_call_count() == 2
    assert H.idle_share(tr.busy_s, tr.window_s) == pytest.approx(25.0)
    assert math.isclose(tr.top_ops()[0][1], 0.002)


def test_chunk_p95_reader_leaves_out_profiled_chunks():
    reader = H.load_metric("chunk_ms_p95")
    times = [float(t) for t in range(1, 201)] + [5000.0, 6000.0]
    res = {"counters": {"chunk_ms": times, "profiled_chunks": [200, 201]}}
    assert reader.read(res) == 190.0
    assert reader.read({"counters": {"chunk_ms": []}}) is None
