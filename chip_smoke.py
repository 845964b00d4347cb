"""On-card smoke check of the PyTorch/CUDA port (megaverse_tpu_torch).

Run `python3 chip_smoke.py` on a machine with one NVIDIA GPU (built for
sm_90a, i.e. an H100). It builds the render kernels from
megaverse_tpu_torch/csrc with nvcc, then

  1. prints the machine (card, power limit, torch/CUDA/nvcc versions, build
     seconds);
  2. holds each kernel form against its plain PyTorch version ON THE CARD:
     a synthetic table with live rows of every primitive type, and the states
     of TowerBuilding (64 envs x 4 agents) and Empty (64 x 2) after 20 random
     steps. B1 (unculled) vs plain: at most 1 per colour channel on fewer than
     1e-4 of the pixels (the elementary functions of the two differ in the
     last place at most). B2 (bit-walk) vs B1: exactly equal;
  3. drives the main path at full width through `VectorEnv`: TowerBuilding
     1024 x 1 and Empty 4096 x 1 for reset + 3 chunks of 64 `step_many` steps
     with a random action pool (numpy seed 0) and a flush; one TowerBuilding
     run of 256 envs x 4 agents with episodeLengthSec=4 so that auto-resets
     and layout refills happen inside the run; one chunk of TowerBuilding 1024 x 1
     with MEGAVERSE_NO_CLUSTER_CULL=1 (the unculled form B1). Launch counts
     are zeroed before and read after each run. The kernels are then held
     against the plain version once more on the full-width states these runs
     end on (comparison launches are not counted);
  4. times both forms and the plain version at the main-path shape and prints
     the `kernels` line (times, launches, largest error, roofline bound).

Any failed check raises and the script exits non-zero. The last line of the
output is {"ok": true, "device": {...}}. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM rate and the f32
# rate outside the tensor cores. The roofline bound below is stated against
# them whatever the card's power limit, which is printed beside it.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# f32 operations (add, mul, div, sqrt, min/max, compare, select) one pixel
# spends on one table row, counted from csrc/render.cu: the intersection
# routine plus the carry update; and on the ray set-up plus the epilogue.
OPS_ROW_AABB = 40
OPS_ROW_OTHER = 100
OPS_PIXEL_FIXED = 150

SOURCE = "megaverse_tpu_torch/csrc/render.cu"
REPLACES = "megaverse_tpu/ops/raycast_pallas.py:109"
TOL_FRACTION = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def channel_diff(a: torch.Tensor, b: torch.Tensor):
    """Packed images -> (largest per-channel abs difference, fraction of pixels
    that differ at all)."""
    worst = 0
    for shift in (16, 8, 0):
        d = (((a >> shift) & 0xFF) - ((b >> shift) & 0xFF)).abs().max().item()
        worst = max(worst, int(d))
    frac = (a != b).float().mean().item()
    return worst, frac


def time_cuda(fn, reps: int) -> float:
    """Mean milliseconds of fn() over `reps` back-to-back calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Smoke:
    def __init__(self):
        from megaverse_tpu_torch.ops import raycast_cuda as RC
        self.RC = RC
        self.dev = torch.device("cuda", 0)
        self.smi = nvidia_smi_line()
        self.max_err = {"render_b1": 0, "render_b2": 0}
        self.launches = {"render_b1": 0, "render_b2": 0}
        self.obs_per_s = {}

    # ------------------------------------------------------------- phase 1
    def machine(self) -> None:
        RC = self.RC
        t0 = time.perf_counter()
        RC.load_library()
        nvcc = subprocess.run([RC.BUILD_INFO["nvcc"], "--version"],
                              capture_output=True, text=True).stdout.strip().splitlines()
        emit({"phase": "machine", "gpu": self.smi,
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "nvcc": nvcc[-2] if len(nvcc) >= 2 else nvcc,
              "build_seconds": RC.BUILD_INFO["seconds"],
              "load_seconds": time.perf_counter() - t0,
              "ptxas": [ln for ln in (RC.BUILD_INFO["log"] or "").splitlines()
                        if "registers" in ln or "spill" in ln][:8]})

    # ------------------------------------------------------------- phase 2
    def cull_tables(self, cams, prims, height):
        RC = self.RC
        prims, clusters = RC.build_clusters(prims)
        clusters, _ = RC.build_superclusters(clusters)
        prims = RC.pad_prims_to_clusters(prims, clusters).contiguous()
        sclist, clbits, scdist, cdist = RC.cull_bits(cams, clusters, height, 128)
        return dict(prims=prims, clusters=clusters.contiguous(), sclist=sclist,
                    clbits=clbits, scdist=scdist, cdist=cdist)

    def compare(self, label, cams, prims, height, ui) -> None:
        """B1 vs plain within tolerance, B2 vs B1 exact, on one input set."""
        RC = self.RC
        plain = RC.render_packed_plain(cams, prims, height, 128, ui_indicators=ui)
        b1 = RC.render_packed(cams, prims, height, 128, ui_indicators=ui)
        tabs = self.cull_tables(cams, prims, height)
        b2 = RC.render_packed(cams, height=height, width=128, ui_indicators=ui, **tabs)
        torch.cuda.synchronize()
        worst, frac = channel_diff(b1, plain)
        exact = bool((b1 == b2).all().item())
        self.max_err["render_b1"] = max(self.max_err["render_b1"], worst)
        w2, _ = channel_diff(b2, plain)
        self.max_err["render_b2"] = max(self.max_err["render_b2"], w2)
        emit({"phase": "kernel_vs_plain", "case": label, "shape": list(b1.shape),
              "rows": int(prims.shape[1]), "b1_max_channel_diff": worst,
              "b1_fraction_differing": frac, "b2_equals_b1": exact,
              "distinct_colours": int(torch.unique(b1).numel())})
        if worst > 1 or frac >= TOL_FRACTION:
            raise AssertionError(f"{label}: B1 disagrees with the plain version "
                                 f"(max {worst}, fraction {frac})")
        if not exact:
            n = int((b1 != b2).sum().item())
            raise AssertionError(f"{label}: B2 differs from B1 on {n} pixels")
        if torch.unique(b1).numel() < 3:
            raise AssertionError(f"{label}: image is (nearly) constant")

    def kernels_vs_plain(self) -> None:
        from megaverse_tpu_torch import VectorEnv
        from megaverse_tpu_torch.env import render_tables
        from megaverse_tpu_torch.utils.synthetic import synthetic_cams, synthetic_prims

        prims_np = synthetic_prims(seed=7, num_envs=8)
        cams_np = synthetic_cams(seed=7, prims=prims_np, num_agents=4)
        prims = torch.from_numpy(prims_np).to(self.dev)
        cams = torch.from_numpy(cams_np).to(self.dev)
        for ui in (False, True):
            self.compare(f"synthetic_all_types_ui={int(ui)}", cams, prims, 72, ui)

        rng = np.random.default_rng(1)
        for name, envs, agents in (("TowerBuilding", 64, 4), ("Empty", 64, 2)):
            env = VectorEnv(name, envs, agents, seed=5)
            env.reset()
            for _ in range(20):
                env.step(rng.integers(0, 2048, size=(envs, agents)).astype(np.int32))
            tabs = render_tables(env.scenario, env.state, bucket=env._bucket, cull=False)
            self.compare(f"{name}_{envs}x{agents}_after_20_steps", tabs["cams"],
                         tabs["prims"], env.scenario.cfg.obs_height,
                         tabs["ui_indicators"])
            env.close()

    # ------------------------------------------------------------- phase 3
    @staticmethod
    def action_pool(num_envs, num_agents, n_pool=16):
        import megaverse_tpu_torch.constants as C
        rng = np.random.default_rng(0)
        md = np.stack(
            [rng.integers(0, s, size=(n_pool, num_envs, num_agents))
             for s in C.ACTION_SPACE_SIZES], axis=-1)
        pool = np.zeros(md.shape[:-1], np.int32)
        for h, bits in enumerate(C.ACTION_HEAD_BITS):
            pool |= np.asarray(bits, np.int32)[md[..., h]]
        return pool

    def drive(self, label, name, envs, agents, chunk, chunks, params=None,
              expect_refill=False, form="render_b2", keep=False):
        """reset + `chunks` x step_many(chunk) + flush through VectorEnv, with
        the launch counts zeroed before and read after."""
        from megaverse_tpu_torch import VectorEnv
        from megaverse_tpu_torch.types import tree_leaves
        RC = self.RC
        env = VectorEnv(name, envs, agents, seed=42, params=params)
        pool = self.action_pool(envs, agents)
        RC.reset_launch_counts()
        obs = env.reset()
        torch.cuda.synchronize()
        any_done = torch.zeros((envs,), dtype=torch.bool, device=self.dev)
        secs = []
        for _ in range(chunks):
            t0 = time.perf_counter()
            obs, dones, csums = env.step_many(pool, chunk)
            _ = int(csums[-1].item())          # wait for the chunk
            secs.append(time.perf_counter() - t0)
            any_done |= torch.stack(dones).any(dim=0)
        env.flush()
        torch.cuda.synchronize()
        counts = dict(RC.LAUNCHES)
        steps = chunk * chunks
        # a first reading: chunks after the first (the first pays one-off costs)
        timed = secs[1:] or secs
        rate = envs * agents * chunk * len(timed) / sum(timed)
        n_done = int(any_done.sum().item())
        emit({"phase": "main_path", "run": label, "scenario": name, "envs": envs,
              "agents": agents, "steps": steps, "launches": counts,
              "obs_per_sec": rate, "ms_per_step": 1e3 * sum(timed) / (chunk * len(timed)),
              "chunk_seconds": secs, "envs_done": n_done,
              "refills": env.num_refills, "refilled_envs": env.num_refilled_envs,
              "gpu": self.smi, "note": "first reading, not a claim"})
        other = "render_b1" if form == "render_b2" else "render_b2"
        if counts[form] != 1 + steps or counts[other] != 0:
            raise AssertionError(f"{label}: launches {counts}, expected "
                                 f"{1 + steps} of {form}")
        for k in counts:
            self.launches[k] += counts[k]
        if obs.dtype != torch.int32 or tuple(obs.shape) != (envs, agents, 72, 128):
            raise AssertionError(f"{label}: obs {obs.dtype} {tuple(obs.shape)}")
        if torch.unique(obs).numel() < 3:
            raise AssertionError(f"{label}: observations are constant")
        st = env.state
        for leaf in tree_leaves(st):
            if leaf.is_floating_point() and not torch.isfinite(leaf).all():
                raise AssertionError(f"{label}: non-finite values in the state")
        if not torch.isfinite(st.total_reward).all():
            raise AssertionError(f"{label}: rewards not finite")
        if expect_refill and (n_done < 1 or env.num_refilled_envs < 1):
            raise AssertionError(f"{label}: no auto-reset/refill happened "
                                 f"(done {n_done}, refilled {env.num_refilled_envs})")
        self.obs_per_s[label] = rate
        env.close()
        return env if keep else None

    def main_path(self):
        from megaverse_tpu_torch.env import render_tables
        tower = self.drive("tower_1024x1", "TowerBuilding", 1024, 1, 64, 3, keep=True)
        empty = self.drive("empty_4096x1", "Empty", 4096, 1, 64, 3, keep=True)
        # TowerBuilding episodes last episodeLengthSec + 4 s per movable box
        # (>= 4 boxes), so with 4 s the shortest is 20 s = 300 steps; with seed
        # 42 the first envs time out at step 480. 22 chunks of 24 steps (the
        # overlapped-refill path: 2 * 24 < 60) see them finish, restart from
        # the layout buffer and get their slots refilled.
        self.drive("tower_256x4_short_episodes", "TowerBuilding", 256, 4, 24, 22,
                   params={"episodeLengthSec": 4.0}, expect_refill=True)
        os.environ["MEGAVERSE_NO_CLUSTER_CULL"] = "1"
        try:
            self.drive("tower_1024x1_unculled", "TowerBuilding", 1024, 1, 64, 1,
                       form="render_b1")
        finally:
            del os.environ["MEGAVERSE_NO_CLUSTER_CULL"]
        # the kernels against the plain version once more, at the very shapes
        # and states the main path ended on
        for label, env in (("TowerBuilding_1024x1", tower), ("Empty_4096x1", empty)):
            tabs = render_tables(env.scenario, env.state, bucket=env._bucket, cull=False)
            self.compare(f"{label}_main_path_state", tabs["cams"], tabs["prims"],
                         env.scenario.cfg.obs_height, tabs["ui_indicators"])
        return tower

    # ------------------------------------------------------------- phase 4
    def kernels_line(self, env) -> None:
        from megaverse_tpu_torch.env import render_tables
        RC = self.RC
        height = env.scenario.cfg.obs_height
        base = render_tables(env.scenario, env.state, bucket=env._bucket, cull=False)
        cams, prims, ui = base["cams"], base["prims"], base["ui_indicators"]
        tabs = self.cull_tables(cams, prims, height)
        bsz, agents = cams.shape[0], cams.shape[1]
        pixels = bsz * agents * height * 128

        ms_b1 = time_cuda(lambda: RC.render_packed(cams, prims, height, 128,
                                                   ui_indicators=ui), 20)
        ms_b2 = time_cuda(lambda: RC.render_packed(cams, height=height, width=128,
                                                   ui_indicators=ui, **tabs), 20)
        ms_plain = time_cuda(lambda: RC.render_packed_plain(
            cams, prims, height, 128, ui_indicators=ui), 2)
        ms_plain_b2 = time_cuda(lambda: RC.render_packed_plain(
            cams, height=height, width=128, ui_indicators=ui, **tabs), 2)
        ms_prologue = time_cuda(lambda: self.cull_tables(cams, prims, height), 10)

        # Roofline bounds from THIS run's inputs. Bytes: every input read once,
        # the output written once. Operations: the rows each pixel visits.
        nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
        out_bytes = pixels * 4
        types = prims[:, :, 0]
        n_aabb = int((types == 0).sum().item())
        n_other = int((types > 0).sum().item())
        n_dead = int((types < 0).sum().item())
        px_per_env = agents * height * 128
        ops_b1 = (px_per_env * (n_aabb * OPS_ROW_AABB + n_other * OPS_ROW_OTHER + n_dead * 2)
                  + pixels * OPS_PIXEL_FIXED)
        bytes_b1 = nbytes(cams, prims) + out_bytes
        visits = RC.new_visits(cams, height)
        RC.render_packed(cams, height=height, width=128, ui_indicators=ui,
                         visits=visits, **tabs)
        torch.cuda.synchronize()
        v = visits.sum(dim=0).tolist()            # clusters run: [aabb, other]
        px_per_block = pixels // visits.shape[0]
        ops_b2 = (px_per_block * 8 * (v[0] * OPS_ROW_AABB + v[1] * OPS_ROW_OTHER)
                  + pixels * OPS_PIXEL_FIXED)
        bytes_b2 = nbytes(cams, *tabs.values()) + out_bytes

        def bound(nb, ops):
            tb, to = 1e3 * nb / HBM_BYTES_PER_S, 1e3 * ops / F32_FLOP_PER_S
            return max(tb, to), ("bytes" if tb >= to else "operations")

        rows = []
        for name, ms, plain_ms, nb, ops in (
                ("render_b1", ms_b1, ms_plain, bytes_b1, ops_b1),
                ("render_b2", ms_b2, ms_plain_b2, bytes_b2, ops_b2)):
            b_ms, by = bound(nb, ops)
            rows.append({"name": name, "route": "cuda", "source": SOURCE,
                         "replaces": REPLACES, "launches": self.launches[name],
                         "max_abs_err": self.max_err[name], "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
                         "library_ms": None})
        emit({"phase": "kernel_times", "shape": [bsz, agents, height, 128],
              "rows": int(prims.shape[1]), "rows_padded": int(tabs["prims"].shape[1]),
              "live_aabb_rows": n_aabb, "live_other_rows": n_other,
              "mean_clusters_run_per_block": sum(v) / visits.shape[0],
              "cull_prologue_ms": ms_prologue, "bytes_b1": bytes_b1, "ops_b1": ops_b1,
              "bytes_b2": bytes_b2, "ops_b2": ops_b2, "gpu": self.smi})
        for r in rows:
            if r["launches"] < 1:
                raise AssertionError(f"{r['name']} was never launched on the main path")
        emit({"kernels": rows})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--phase", default="all", choices=["all", "kernels"],
                    help="'kernels' stops after the kernel-vs-plain comparison "
                         "(prints no result line)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check only runs on the GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke = Smoke()
    smoke.machine()
    smoke.kernels_vs_plain()
    if args.phase == "kernels":
        return 0
    tower = smoke.main_path()
    smoke.kernels_line(tower)
    print(smoke.smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
