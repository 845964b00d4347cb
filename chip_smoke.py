"""On-card smoke check of the PyTorch/CUDA port (megaverse_tpu_torch).

Run `python3 chip_smoke.py` on a machine with one NVIDIA GPU (built for
sm_90a, i.e. an H100). It builds the render kernel, the deferred reset's
masked-copy kernel, the character controller's kernel (csrc/kcc.cu) and the
object-stacking kernel (csrc/stacking.cu) from megaverse_tpu_torch/csrc with
nvcc (one process per source, at once), then

  1. prints the machine (card, power limit, torch/CUDA/nvcc versions, build
     seconds);
  2. holds every form of the render kernel against form B1 and against its
     plain PyTorch version ON THE CARD: a synthetic table with live rows of
     every primitive type (reward indicators off and on), a synthetic table
     whose hits lie 90-125 m out and whose rays graze box faces (where the
     0.01 slack of the distance bounds and box votes is tightest), a table of
     571 clusters (more than the kernel stages at once: B3 takes its boxes
     in two chunks, B4 and B5 walk their lists in many batches of 32), and the
     states of Collect (64 envs x 2 agents), TowerBuilding (64 x 4),
     Empty (64 x 2, a table shorter than 8 clusters), Sokoban, Rearrange
     (ellipsoid and cylinder rows), BoxAGone (up to 972 tile rows whose
     scales and flags change every tick), Football (a sphere), HexExplore
     and HexMemory (rot-box and fused wall rows) (64 x 2 each) after 20
     random steps. B1 (unculled) vs
     plain: at most 1 per colour channel on fewer than 1e-4 of the pixels (the
     elementary functions of the two differ in the last place at most; on
     the states of Sokoban, Rearrange, BoxAGone and Football: 0 levels). B2
     (bit-walk), B3 (clustered), B4 (per-agent lists without and with distance
     bounds, per-tile lists, a shuffled permutation), B5 (superclusters, with
     a prim table that is not padded to whole superclusters) and B6 (the
     merged launch of each of B1-B5) vs B1: exactly equal; each vs its own
     plain version: the tolerance above. On the hex states also B2 with the
     PVS cluster mask as `render_tables` builds it by default: exactly equal
     to B1, within the tolerance of its plain version, and the mask must have
     removed at least one cluster the frustum test kept. The free camera
     (`env.render_custom_camera`: B1 at any size) on the Collect state at
     144 x 256, 100 x 200 and 720 x 1280 (FREE_CAMERA_SIZES) vs its plain
     version: the tolerance above;
  3. drives the main path at full width through `VectorEnv`: reset +
     `step_many` chunks of 64 steps with a random action pool (numpy seed 0) +
     flush, for Empty 4096 x 1, Collect 1024 x 1, ObstaclesHard 1024 x 1,
     Sokoban, Rearrange, BoxAGone and Football 1024 x 1, HexExplore and
     HexMemory 1024 x 1 (2 chunks each) under the default mode (B2, with the
     PVS mask of the hex scenes), and TowerBuilding 1024 x 1 through the
     sampling benchmark's entry point (bench_torch.bench_scenario, BENCH_RUN:
     reset, its warm-up of WARMUP_CHUNKS chunks of 64 with their flushes and
     2 timed chunks of 64; it prints bench.py's JSON line for the run; B2
     launches == 1 reset + every step, the final state finite, the envs'
     last frames not all alike, obs/s positive); on the TowerBuilding
     1024 x 1 env after its run one chunk of 16 steps with
     MEGAVERSE_NO_CLUSTER_CULL=1 (B1), and on the Collect 1024 x 1 env after
     its run one chunk of 16 steps each with MEGAVERSE_RENDER_MODE=super
     (B5), plus MEGAVERSE_NO_SUPERCLUSTERS=1 (B4, per-tile lists), plus
     MEGAVERSE_NO_CLUSTER_SORT=1 (B3), and with MEGAVERSE_MERGE_TILES=1 (B6
     over B2), then with render size classes switched on (its state rendered
     with and without them bit-equal, one chunk of 16 steps: B2 launches ==
     class groups x 16) and the free camera at the three sizes through
     `render_custom_camera` (3 B1 launches); and runs whose episodes are
     short enough for auto-resets
     and layout refills to happen inside them
     (TowerBuilding 256 envs x 4 agents, Collect 256 x 2, Sokoban 256 x 2
     and HexExplore 256 x 2 with episodeLengthSec=4, Test 256 x 1). The hex
     scenes' layouts need the native host library (native/, built with g++
     at first use): without it the script stops before any run. Launch
     counts are zeroed before and read after each run and must equal resets
     + steps for the form the mode selects, 0 for the others. The kernels
     are then held against the plain version once more on the full-width
     states these runs end on (comparison launches are not counted; every
     form 0 levels from its plain version at the end states of Sokoban,
     Rearrange, BoxAGone and Football; B2 with the PVS mask equal to B1 at
     the hex end states). Every run steps through `VectorEnv`'s default
     path: each tick replayed from its CUDA graph (megaverse_tpu_torch/
     capture.py), the deferred reset through the masked-copy kernel where
     the scenario takes it (12 of the 16 scenes): one masked copy per tick
     there, none elsewhere. Then (3b) on the envs these runs end on: one
     eager tick of each under torch.cuda.set_sync_debug_mode("error") (no
     host synchronisation in a tick); on TowerBuilding, Collect,
     ObstaclesHard and HexMemory 1024 x 1 (CAPTURE_SCENES) CAPTURE_TICKS
     ticks from one snapshot eagerly (under the same sync check) and
     captured, with forced time-outs, a refill into the layout buffer and a
     larger render bucket (a re-capture) inside: obs, dones and every state
     leaf bit for bit equal, the KCC kernel launched once per tick either
     way; then the step captured and eager in this call
     (ms, obs/s, host ops and graph replays per step, device kernels per
     step, captures, peak memory); on the Collect env one tick of each form
     B1-B6 captured against eager the same way, and 4 ticks eager and
     captured with CACHE_SIZES other free-camera frame sizes rendered before
     a replay (the replay's cached render constants must stay its own);
     the masked copy against its
     plain version on ObstaclesHard's layout leaves with none, 8 and all
     1,024 envs done, bit for bit, and timed; the KCC kernel
     (ops/kcc.physics_step) against its plain version (player_step, then
     resolve_agent_collisions) on one tick from the end states of Collect,
     ObstaclesHard (terrain, falls) and HexMemory (rotated walls) 1024 x 1
     and TowerBuilding 256 x 4 (agent collisions): pos, vvel and hvel bit
     for bit, jumping and on_ground equal, both timed (`kcc_check`); every
     run's KCC launches == its ticks; the stacking kernel
     (components.object_stacking_step on the card) against its plain version
     (object_stacking_step_plain) on two ticks of every agent pressing
     Interact from the end states of Collect, ObstaclesHard and Rearrange
     (its place zone) 1024 x 1 and TowerBuilding 256 x 4 (four passes, its
     zone): every leaf it writes, picked, placed and place_voxel bit for bit,
     both timed (`stacking_check`); every run's stacking launches == its
     ticks on the ten scenes with stacking (STACKING_SCENES), 0 elsewhere. Then ObstaclesMedium, ObstaclesSteps,
     ObstaclesWalls and ObstaclesLava (OBSTACLES_VARIANTS) at VARIANT_ENVS x 1
     the same way (2 chunks), each held at its end state: every form equal
     to B1, each within the tolerance of its own plain version, B2 timed;
  4. the training path (megaverse_tpu_torch.rl; the learner's rollout replays
     the same tick graph, one masked copy per rollout step of a task that
     defers its reset), at the full width of the
     repo's one model (hidden 512, 2-layer GRU, 72x128 observations): the
     learner's `_update_from_batch` on the card against the same update on
     the CPU from the same parameters, on a numpy-seeded batch (8 envs x 2
     agents x 32 steps), for the float32 model (loss 1e-4 relative,
     gradients 2e-3 of their norm, parameters after 1e-4 on all but 1e-4 of
     them) and the bfloat16 one (loss 1e-2, gradients 2e-2, parameters after
     1e-4 on all but 1e-2 of them); every parameter within 2 lr, the most
     one Adam step can move it. The gradients differ where a ReLU's input
     lies within rounding of zero on one device and not the other: such a
     unit switches its whole gradient on or off (on this batch one unit,
     5.3e-4 of the gradients' norm in float32: scripts/
     learner_grad_agreement.py). A gradient entry smaller than that may take
     either sign, and Adam's first step moves it by lr whatever its size.
     Then `rl.train.main` trains Collect 512 envs x 2
     agents for 3 updates of rollout 32 (B2 launches == 3 * 32 + 1: one at
     init, one per rollout step; finite loss; parameters moved), and
     `rl.enjoy.main` plays the checkpoint it wrote on the card for 20 steps
     (B2 launches == 21); the same for TowerBuilding 256 x 4 (rl/runs.py's
     megaverse_4ag) with team-spirit annealing over two updates' env steps
     (the shaping column == min(1, steps done / max steps) after every
     update), enjoy with four agents; and multitask training
     (megaverse_multitask8: the Megaverse-8 x 1,024 envs, one shared policy
     and Adam state, one update per task in MEGAVERSE8 order: B2 launches ==
     8 * 32 + 8, every task's metrics finite, each task's envs advanced
     only on its own turn; its line has the tasks' rollout and update ms,
     setup seconds, device memory after setup and peak);
  6. data parallelism (megaverse_tpu_torch.parallel): NCCL at world size
     1, where one `ParallelLearner` update of step 4's float32 batch must be
     bit-equal to the plain learner's (cuDNN deterministic); then two gloo
     ranks spawned on the one card (NCCL refuses two ranks on one device),
     each holding 256 of Collect 512 x 2's envs: their VectorEnv sampling
     (reset + 3 steps), joined in rank order, must equal one process's bit
     for bit, and after one training step of the trainer's task (rollout 32,
     hidden 512, gradients averaged over the ranks) the replicas' parameters
     must be bit-equal; each rank's B2 launches == 1 + 3 + 1 + 32;
  5. times every form and its plain version at the Collect 1024 x 1 shape
     (B6 over B2, B3, B4's per-tile lists and B5; B1, B2, B3 and B6 over B2
     also at the TowerBuilding 1024 x 1 shape; B2 at the end state of each
     run of Sokoban, Rearrange, BoxAGone, Football, the Obstacles variants
     and the hex scenes, the latter with and without the PVS mask; B1 for the
     free camera at its three sizes) and prints the `kernels` line (times,
     launches, largest error, roofline bound, clusters run per pixel).

The phases run in the order 1, 2, 3, 4, 6, 5; every phase line carries
`wall_seconds`, the script's time since the previous phase line.
`--phase kernels` stops after step 2, `--phase train` runs steps 1 and 4
only, `--phase parallel` steps 1 and 6 only, `--phase bench` step 1 and
step 3's TowerBuilding run, `--phase obstacles` step 1 and step 3's
Obstacles variants, `--phase capture` step 1 and step 3b on TowerBuilding
and Collect 1024 x 1 driven for 2 chunks each, `--phase kcc` step 1 and the
KCC kernel's check on its four end states (KCC_RUNS) driven for 2 chunks
each, `--phase stacking` step 1 and the stacking kernel's check on its four
end states (STACKING_RUNS) (none of them prints the result line).

Any failed check raises and the script exits non-zero. The last line of the
output is {"ok": true, "device": {...}}. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
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
MASKED_COPY_SOURCE = "megaverse_tpu_torch/csrc/masked_copy.cu"
# the deferred reset's masked copy replaces no TPU kernel: the reference's
# apply_deferred_resets is plain JAX (a K-slot scatter under lax.cond)
MASKED_COPY_REPLACES = "megaverse_tpu/env.py:168 (apply_deferred_resets; plain JAX, no TPU kernel)"
KCC_SOURCE = "megaverse_tpu_torch/csrc/kcc.cu"
KCC_REPLACES = ("megaverse_tpu/ops/physics.py:296,519 (player_step, resolve_agent_collisions; "
                "plain JAX, no TPU kernel)")
# the KCC kernel's check (`kcc_check`): the main path's runs whose end states
# it starts from, (label, scenario, envs, agents, chunk, chunks, params):
# terrain and falls, rotated walls, four agents per env, and the cells' scene
KCC_RUNS = (("collect_1024x1", "Collect", 1024, 1, 64, 2, None),
            ("obstacleshard_1024x1", "ObstaclesHard", 1024, 1, 64, 2, None),
            ("hexmemory_1024x1", "HexMemory", 1024, 1, 64, 2, None),
            ("tower_256x4_short_episodes", "TowerBuilding", 256, 4, 24, 22,
             {"episodeLengthSec": 4.0}))
STACKING_SOURCE = "megaverse_tpu_torch/csrc/stacking.cu"
STACKING_REPLACES = ("megaverse_tpu/scenarios/components.py (object_stacking_step; "
                     "plain JAX, no TPU kernel)")
# the scenes whose tick runs the stacking component: one stacking launch a
# tick there, none elsewhere
STACKING_SCENES = ("Collect", "Test", "ObstaclesEasy", "ObstaclesMedium", "ObstaclesHard",
                   "ObstaclesWalls", "ObstaclesSteps", "ObstaclesLava", "Rearrange",
                   "TowerBuilding")
# the stacking kernel's check (`stacking_check`): the runs whose end states it
# starts from, as KCC_RUNS: one agent, terrain, a place zone on every env, and
# four sequential passes with TowerBuilding's zone
STACKING_RUNS = (KCC_RUNS[0], KCC_RUNS[1],
                 ("rearrange_1024x1", "Rearrange", 1024, 1, 64, 2, None), KCC_RUNS[3])
# the reference kernel body and, per form, the lines of its traversal
REPLACES = {
    "render_b1": "megaverse_tpu/ops/raycast_pallas.py:931",
    "render_b2": "megaverse_tpu/ops/raycast_pallas.py:693",
    "render_b3": "megaverse_tpu/ops/raycast_pallas.py:610",
    "render_b4": "megaverse_tpu/ops/raycast_pallas.py:885",
    "render_b5": "megaverse_tpu/ops/raycast_pallas.py:820",
    "render_b6": "megaverse_tpu/ops/raycast_pallas.py:1008",
}
TOL_FRACTION = 1e-4

# The captured tick against the eager one (capture_check): the main path's
# 1024 x 1 envs of these scenes after their runs, CAPTURE_TICKS ticks from
# the same snapshot each way, with a refill into the layout buffer and a
# larger render bucket (a re-capture) at tick CAPTURE_REFILL_AT; the first
# CAPTURE_EARLY envs time out at the second tick, the next CAPTURE_EARLY
# after the refill, from their refilled slots.
CAPTURE_SCENES = ("TowerBuilding", "Collect", "ObstaclesHard", "HexMemory")
CAPTURE_TICKS = 8
CAPTURE_REFILL_AT = 4
CAPTURE_EARLY = 16
# envs done in the masked copy's timed case (about the resets per tick of
# 1,024 ObstaclesHard envs, 90 s episodes at 15 Hz: 0.76, and their tail)
MASKED_COPY_DONE = 8
# free-camera frame sizes rendered between two replays of a captured tick,
# each caching render constants of its own (constants_check)
CACHE_SIZES = 20
# scenarios with a 1024 x 1 main-path run whose end state B2 is timed at;
# on the states of the first four every form is held 0 levels from its plain
# version
NEW_SCENES = {"Sokoban": "sokoban_1024x1", "Rearrange": "rearrange_1024x1",
              "BoxAGone": "boxagone_1024x1", "Football": "football_1024x1"}
# the hex scenes: their layouts carry a PVS render mask, which the bit-walk's
# cull takes by default
HEX_SCENES = {"HexExplore": "hexexplore_1024x1", "HexMemory": "hexmemory_1024x1"}

# case of the comparison -> the launch counter (kernel form) it exercises
CASE_FORM = {"b2": "render_b2", "b3": "render_b3", "b4_agent": "render_b4",
             "b4_agent_dist": "render_b4", "b4_tile": "render_b4",
             "b4_shuffled": "render_b4", "b5": "render_b5"}


# rollout, envs, agents, hidden of the learner's card-vs-CPU check
UPDATE_SHAPE = (32, 8, 2, 512)

# (height, width) of the free camera (env.render_custom_camera) through B1:
# twice the agents' view, a size that is no multiple of the 8 x 128 tiles,
# and 720p
FREE_CAMERA_SIZES = ((144, 256), (100, 200), (720, 1280))

# the parallel phase's two gloo ranks on the one card: Collect 512 envs x 2
# agents (256 per rank), sampled for 3 steps, then one training step at the
# training path's width (hidden 512, rollout 32)
PARALLEL_SAMPLING = dict(label="collect_512x2", name="Collect", num_envs=512, num_agents=2,
                         seed=42, steps=3)
PARALLEL_TRAIN = dict(name="Collect", num_envs=512, num_agents=2, rollout=32,
                      hidden_size=512, seed=42)
PARALLEL_DEVICES = ["cuda:0", "cuda:0"]

# the main path's TowerBuilding 1024 x 1 run goes through the sampling
# benchmark's entry point, bench_torch.bench_scenario, at the suite's width:
# reset, the benchmark's warm-up (WARMUP_CHUNKS chunks of 64 with their
# flushes), 2 timed chunks of 64
BENCH_RUN = dict(scenario="TowerBuilding", num_envs=1024, num_agents=1, chunk=64, chunks=2)

# the Obstacles variants that no other run drives. 256 envs, not the 1,024
# at which bench.py times the family: at 1024 x 1 their runs took 120 s (85 s
# of it host layouts) of the script's 1,005 s on one H100 machine, against a
# limit of 1,200 s; ObstaclesHard's run at 1024 x 1 already takes the
# family's widest layouts through the card
VARIANT_ENVS = 256
OBSTACLES_VARIANTS = {name: f"{name.lower()}_{VARIANT_ENVS}x1" for name in (
    "ObstaclesMedium", "ObstaclesSteps", "ObstaclesWalls", "ObstaclesLava")}

# the training runs at the width of rl/runs.py's configurations, hidden 512,
# 2-layer GRU, rollout 32 (rl.train's defaults): Collect 512 x 2; four agents
# per env (megaverse_4ag) with team-spirit annealing over two updates' env
# steps; multitask (megaverse_multitask8: the Megaverse-8, 1,024 envs each,
# one update per task, round-robin)
TRAIN_RUN = dict(env="Collect", num_envs=512, agents=2, updates=3)
TRAIN_4AG = dict(env="TowerBuilding", num_envs=256, agents=4, updates=3)
MULTITASK = dict(env="multitask_megaverse8", num_envs=1024, agents=1, updates=8)
ROLLOUT = 32
ENJOY_STEPS = 20


def form_counts(RC) -> dict:
    """The render forms' launch counts (RC.LAUNCHES counts the masked copy
    too)."""
    return {k: RC.LAUNCHES[k] for k in RC.FORMS}


def free_camera_view(env):
    """(eye, yaw, pitch) of an overview of env 0's scene: above and behind
    the middle of its grid, looking down (scripts/record_episode_torch.py)."""
    grid = env.scenario.cfg.grid
    center = np.asarray(grid.origin) + np.asarray(grid.dims) * grid.voxel_size / 2
    return (center[0], center[1] + np.max(grid.dims) * 0.7, center[2] + 6), 0.0, -1.1


def update_check_inputs():
    """numpy inputs of the learner's card-vs-CPU check at full width (numpy
    seed 0): a rollout batch (packed observations, actions, a behaviour logp
    around the uniform policy's so that the ratio clip acts, values, rewards,
    5 % done rows, the initial carry), the last observations and carry, and
    fresh parameters (flax's initializers from torch seed 0) on the CPU."""
    import megaverse_tpu_torch.constants as C
    from megaverse_tpu_torch.models.actor_critic import ActorCritic

    t_len, envs, agents, hidden = UPDATE_SHAPE
    rng = np.random.default_rng(0)
    carry = 2 * hidden
    batch = dict(
        obs=rng.integers(0, 1 << 24, (t_len, envs, agents, 72, 128), dtype=np.int32),
        actions=np.stack([rng.integers(0, n, (t_len, envs, agents))
                          for n in C.ACTION_SPACE_SIZES], -1).astype(np.int64),
        logp=(-5.78 + rng.normal(0, 0.3, (t_len, envs, agents))).astype(np.float32),
        value=rng.normal(0, 0.5, (t_len, envs, agents)).astype(np.float32),
        reward=rng.normal(0, 1.0, (t_len, envs, agents)).astype(np.float32),
        done=rng.random((t_len, envs)) < 0.05,
        init_carry=rng.normal(0, 0.5, (envs, agents, carry)).astype(np.float32))
    last_obs = rng.integers(0, 1 << 24, (envs, agents, 72, 128), dtype=np.int32)
    last_carry = rng.normal(0, 0.5, (envs, agents, carry)).astype(np.float32)
    init = ActorCritic(hidden_size=hidden, generator=torch.Generator().manual_seed(0))
    params = {k: v.detach().clone() for k, v in init.state_dict().items()}
    return batch, last_obs, last_carry, params


def update_check_setup(dev, model_dtype, inputs):
    """(learner, learner state, rollout batch) of the check on `dev`; with a
    float64 model every float input and parameter is float64 too."""
    from megaverse_tpu_torch.rl import learner as L
    from megaverse_tpu_torch.scenarios import make_scenario

    batch_np, last_obs, last_carry, params0 = inputs
    t_len, envs, agents, hidden = UPDATE_SHAPE
    wide = torch.float64 if model_dtype == torch.float64 else torch.float32

    def put(x):
        t = torch.as_tensor(x)
        return (t.to(wide) if t.is_floating_point() else t).to(dev)

    learner = L.Learner(make_scenario("Collect", num_agents=agents), envs, L.TrainConfig(
        rollout=t_len, hidden_size=hidden, model_dtype=model_dtype), device=dev)
    params = {k: put(v) for k, v in params0.items()}
    batch = L.RolloutBatch(*(put(batch_np[k]) for k in (
        "obs", "actions", "logp", "value", "reward", "done", "init_carry")))
    ls = L.LearnerState(params, L.adam_init(params), None, put(last_obs), put(last_carry),
                        torch.Generator(dev).manual_seed(0), 0)
    return learner, ls, batch


_LAST_PHASE_LINE = [time.perf_counter()]


def emit(obj) -> None:
    """Print one JSON line. A phase line also gets `wall_seconds`: the host
    seconds since the previous phase line (the script's start for the
    first), i.e. what the work it reports took of the script's time."""
    if "phase" in obj:
        now = time.perf_counter()
        obj = dict(obj, wall_seconds=now - _LAST_PHASE_LINE[0])
        _LAST_PHASE_LINE[0] = now
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def ptxas_summary(log: str) -> dict:
    """`nvcc -Xptxas -v` output -> {"B<form>" or "B<form> merged": "<n>
    registers, <s> B spill stores"}, one entry per instantiation of the
    kernel template."""
    out, name, spill = {}, None, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(r"render_kernelILi(\d)ELb([01])E", m.group(1))
            name = k and f"B{k.group(1)}" + (" merged" if k.group(2) == "1" else "")
            spill = 0
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name] = f"{m.group(1)} registers, {spill} B spill stores"
            name = None
    return out


def ptxas_single(builds: dict, stem: str) -> str:
    """A one-kernel source's registers and spill stores from its build's
    `-Xptxas -v` output ("" where the build was found from an earlier one)."""
    log = builds.get(stem, {}).get("log") or ""
    regs = re.findall(r"Used (\d+) registers", log)
    spills = re.findall(r"(\d+) bytes spill stores", log)
    return f"{regs[0]} registers, {spills[0] if spills else 0} B spill stores" if regs else ""


def channel_diff(a: torch.Tensor, b: torch.Tensor):
    """Packed images -> (largest per-channel abs difference, fraction of pixels
    that differ at all)."""
    worst = 0
    for shift in (16, 8, 0):
        d = (((a >> shift) & 0xFF) - ((b >> shift) & 0xFF)).abs().max().item()
        worst = max(worst, int(d))
    frac = (a != b).float().mean().item()
    return worst, frac


def time_cuda(fn, reps: int, warm: bool = True) -> float:
    """Mean milliseconds of fn() over `reps` back-to-back calls (CUDA events),
    after one untimed call unless `warm` is False."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_graph(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over `reps` calls captured into one
    CUDA graph and replayed (CUDA events): the host's cost of launching a
    short kernel from Python stays out of the reading, as it does when the
    tick's graph replays the kernel."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class ModeEnv:
    """Set the render-mode environment variables for the duration of a block."""

    def __init__(self, **env):
        self.env = env
        self.previous = {}

    def __enter__(self):
        self.previous = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k, old in self.previous.items():
            if old is None:
                del os.environ[k]
            else:
                os.environ[k] = old


class Smoke:
    def __init__(self):
        from megaverse_tpu_torch.ops import masked_copy as MC
        from megaverse_tpu_torch.ops import raycast_cuda as RC
        from megaverse_tpu_torch.utils.synthetic import form_tables
        self.RC = RC
        self.MC = MC
        self.form_tables = form_tables
        self.dev = torch.device("cuda", 0)
        self.smi = nvidia_smi_line()
        self.max_err = {name: 0 for name in RC.FORMS}
        self.launches = {name: 0 for name in RC.FORMS}
        self.obs_per_s = {}
        # launches of the free camera, the class chunk and the parallel ranks
        self.launches_by_part = {}
        self.saw_unpadded_b5 = False
        self.saw_short_table = False
        # the masked copy's launches on the main path, and its timings
        self.mc_launches = 0
        self.mc_row = None
        # the KCC kernel's launches on the main path, and its readings by run
        self.kcc_launches = 0
        self.kcc_cases = {}
        # the same for the stacking kernel
        self.stacking_launches = 0
        self.stacking_cases = {}

    def reset_counts(self) -> None:
        self.RC.reset_launch_counts()

    # ------------------------------------------------------------- phase 1
    def machine(self) -> None:
        from megaverse_tpu_torch.ops import kcc as K
        from megaverse_tpu_torch.ops import stacking as S
        from megaverse_tpu_torch.utils import native
        RC = self.RC
        # The hex scenes' layouts search the maze's portals for visibility:
        # the native library does that in tens of milliseconds per layout, the
        # python fallback in seconds, so without it the runs would take hours.
        t0 = time.perf_counter()
        have_native = native.have_native()
        native_seconds = time.perf_counter() - t0
        # every kernel source built at once, one nvcc each
        from concurrent.futures import ThreadPoolExecutor
        t0 = time.perf_counter()
        with ThreadPoolExecutor(4) as pool:
            for fut in [pool.submit(RC.load_library), pool.submit(self.MC.load_library),
                        pool.submit(K.load_library), pool.submit(S.load_library)]:
                fut.result()
        nvcc = subprocess.run([RC.BUILD_INFO["nvcc"], "--version"],
                              capture_output=True, text=True).stdout.strip().splitlines()
        builds = {k: v for k, v in RC.BUILD_INFO.items() if k != "nvcc"}
        emit({"phase": "machine", "gpu": self.smi,
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "nvcc": nvcc[-2] if len(nvcc) >= 2 else nvcc,
              "build_seconds": {k: v["seconds"] for k, v in builds.items()},
              "load_seconds": time.perf_counter() - t0,
              "native_library": have_native, "native_seconds": native_seconds,
              "ptxas": ptxas_summary(builds.get("render", {}).get("log") or ""),
              "ptxas_masked_copy": re.findall(r"Used \d+ registers[^\n]*",
                                              builds.get("masked_copy", {}).get("log") or ""),
              "ptxas_kcc": ptxas_single(builds, "kcc"),
              "ptxas_stacking": ptxas_single(builds, "stacking")})
        if not have_native:
            raise AssertionError("the native host library (native/build.sh) did not "
                                 "build or load: hex layouts would take the python "
                                 "portal search")

    # ------------------------------------------------------------- phase 2
    def compare(self, label, cams, prims, height, ui, plain_cases=None,
                exact=False) -> None:
        """On one input set: B1 vs plain within tolerance; every other form,
        tiled and merged, exactly equal to B1; the cases named in
        `plain_cases` (default: all) also against their own plain version.
        With `exact`, every form must be 0 levels from its plain version."""
        RC = self.RC

        def within(w, f):
            return w == 0 if exact else (w <= 1 and f < TOL_FRACTION)

        render = lambda **kw: RC.render_packed(cams, height=height, width=128,
                                               ui_indicators=ui, **kw)
        plain = RC.render_packed_plain(cams, prims, height, 128, ui_indicators=ui)
        b1 = render(prims=prims)
        torch.cuda.synchronize()
        worst, frac = channel_diff(b1, plain)
        self.max_err["render_b1"] = max(self.max_err["render_b1"], worst)
        if not within(worst, frac):
            raise AssertionError(f"{label}: B1 disagrees with the plain version "
                                 f"(max {worst}, fraction {frac})")
        if torch.unique(b1).numel() < 3:
            raise AssertionError(f"{label}: image is (nearly) constant")
        cases = self.form_tables(cams, prims, height, 128)
        g = cases["b3"]["clusters"].shape[1]
        self.saw_short_table |= g < 8
        self.saw_unpadded_b5 |= cases["b5"]["prims"].shape[1] < 8 * cases["b5"]["clusters"].shape[1]
        report = {}
        images = {"b1_merged": render(prims=prims, merge_tiles=True)}
        for case, tabs in cases.items():
            images[case] = render(**tabs)
            images[case + "_merged"] = render(merge_tiles=True, **tabs)
        torch.cuda.synchronize()
        for case, img in images.items():
            if not bool((img == b1).all().item()):
                n = int((img != b1).sum().item())
                raise AssertionError(f"{label}: {case} differs from B1 on {n} pixels")
            report[case] = "== b1"
        for case, tabs in cases.items():
            if plain_cases is not None and case not in plain_cases:
                continue
            own = RC.render_packed_plain(cams, height=height, width=128,
                                         ui_indicators=ui, **tabs)
            for shape, name in ((case, CASE_FORM[case]), (case + "_merged", "render_b6")):
                w, f = channel_diff(images[shape], own)
                self.max_err[name] = max(self.max_err[name], w)
                if not within(w, f):
                    raise AssertionError(f"{label}: {shape} disagrees with its plain "
                                         f"version (max {w}, fraction {f})")
            report[case] += f", plain max {w}"
        emit({"phase": "kernel_vs_plain", "case": label, "shape": list(b1.shape),
              "rows": int(prims.shape[1]), "clusters": int(g),
              "row_types": {str(int(k)): int(n) for k, n in zip(
                  *torch.unique(prims[..., 0], return_counts=True))},
              "plain_tolerance": "0 levels" if exact else "1 level on < 1e-4",
              "b1_max_channel_diff": worst, "b1_fraction_differing": frac,
              "forms": report, "distinct_colours": int(torch.unique(b1).numel())})
        return cases

    def pvs_check(self, label, env) -> None:
        """B2 with the scenario's PVS cluster mask, as `render_tables` builds
        it by default: exactly equal to B1 (tiled and merged), within the
        tolerance of its plain version, and the mask removed at least one
        cluster that the frustum test kept."""
        from megaverse_tpu_torch.env import UNCULLED, RenderMode, render_tables
        RC = self.RC
        height = env.scenario.cfg.obs_height
        tables = lambda mode: render_tables(env.scenario, env.state, bucket=env._bucket,
                                            mode=mode)
        masked, unmasked, b1_tabs = (tables(RenderMode()), tables(RenderMode(pvs=False)),
                                     tables(UNCULLED))
        g = masked["clusters"].shape[1]
        on = RC.cluster_bits(masked["clbits"], g)
        off = RC.cluster_bits(unmasked["clbits"], g)
        removed = int((off & ~on).sum().item())
        if removed < 1 or bool((on & ~off).any().item()):
            raise AssertionError(f"{label}: the PVS mask removed {removed} clusters "
                                 "(none, or it added some)")
        b1 = RC.render_packed(height=height, width=128, **b1_tabs)
        img = RC.render_packed(height=height, width=128, **masked)
        merged = RC.render_packed(height=height, width=128, **dict(masked, merge_tiles=True))
        torch.cuda.synchronize()
        for shape, im in (("b2_pvs", img), ("b2_pvs_merged", merged)):
            if not bool((im == b1).all().item()):
                raise AssertionError(f"{label}: {shape} differs from B1 on "
                                     f"{int((im != b1).sum().item())} pixels")
        plain = RC.render_packed_plain(height=height, width=128, **masked)
        w, f = channel_diff(img, plain)
        self.max_err["render_b2"] = max(self.max_err["render_b2"], w)
        if not (w <= 1 and f < TOL_FRACTION):
            raise AssertionError(f"{label}: B2 with the PVS mask disagrees with its "
                                 f"plain version (max {w}, fraction {f})")
        emit({"phase": "pvs_mask", "case": label, "clusters": g,
              "tile_clusters_kept_by_frustum": int(off.sum().item()),
              "tile_clusters_removed_by_mask": removed,
              "b2_pvs": "== b1 (tiled, merged)", "plain_max_channel_diff": w,
              "plain_fraction_differing": f})

    def kernels_vs_plain(self) -> None:
        from megaverse_tpu_torch import VectorEnv
        from megaverse_tpu_torch.env import UNCULLED, RenderMode, render_tables
        from megaverse_tpu_torch.utils.synthetic import (synthetic_cams, synthetic_far,
                                                         synthetic_prims)

        prims_np = synthetic_prims(seed=7, num_envs=8)
        cams_np = synthetic_cams(seed=7, prims=prims_np, num_agents=4)
        prims = torch.from_numpy(prims_np).to(self.dev)
        cams = torch.from_numpy(cams_np).to(self.dev)
        for ui in (False, True):
            self.compare(f"synthetic_all_types_ui={int(ui)}", cams, prims, 72, ui)
        prims_np, cams_np = synthetic_far(seed=7, num_envs=16, num_agents=4)
        self.compare("synthetic_far_plane_grazing", torch.from_numpy(cams_np).to(self.dev),
                     torch.from_numpy(prims_np).to(self.dev), 72, False)
        # more clusters than the kernel stages at once: B3 takes its boxes in
        # two chunks, B6 over B2 streams what a frame cannot stage, B4 and B5
        # walk their lists in many batches
        prims_np = np.concatenate([synthetic_prims(seed=s, num_envs=2) for s in range(55)],
                                  axis=1)
        cams_np = synthetic_cams(seed=7, prims=prims_np, num_agents=4)
        if prims_np.shape[1] <= 8 * 512:
            raise AssertionError("the large table must hold more than 512 clusters")
        cases = self.compare("synthetic_large_table", torch.from_numpy(cams_np).to(self.dev),
                             torch.from_numpy(prims_np).to(self.dev), 72, False)
        for case in ("b4_tile", "b5"):
            # some list holds more entries within the far plane than one batch
            reach = int((cases[case]["dist"] <= self.RC.FAR).sum(dim=-1).max().item())
            if reach <= self.RC.B3_BATCH:
                raise AssertionError(f"synthetic_large_table: {case}'s lists fit one batch")

        rng = np.random.default_rng(1)
        for name, envs, agents in (("Collect", 64, 2), ("TowerBuilding", 64, 4),
                                   ("Empty", 64, 2), ("Sokoban", 64, 2),
                                   ("Rearrange", 64, 2), ("BoxAGone", 64, 2),
                                   ("Football", 64, 2), ("HexExplore", 64, 2),
                                   ("HexMemory", 64, 2)):
            env = VectorEnv(name, envs, agents, seed=5)
            env.reset()
            for _ in range(20):
                env.step(rng.integers(0, 2048, size=(envs, agents)).astype(np.int32))
            tabs = render_tables(env.scenario, env.state, bucket=env._bucket, mode=UNCULLED)
            self.compare(f"{name}_{envs}x{agents}_after_20_steps", tabs["cams"],
                         tabs["prims"], env.scenario.cfg.obs_height,
                         tabs["ui_indicators"], exact=name in NEW_SCENES)
            if name in HEX_SCENES:
                self.pvs_check(f"{name}_{envs}x{agents}_after_20_steps", env)
            if name == "Collect":
                self.free_camera_compare(f"{name}_{envs}x{agents}_after_20_steps", env)
            if name == "Empty":
                # short tables take per-tile cluster lists, not superclusters
                short = render_tables(env.scenario, env.state, bucket=env._bucket,
                                      mode=RenderMode(mode="super"))
                if short["clusters"].shape[1] >= 8 or "sclusters" in short \
                        or short["order"].dim() != 4:
                    raise AssertionError("Empty: the short-table rule did not apply")
            env.close()
        if not (self.saw_short_table and self.saw_unpadded_b5):
            raise AssertionError("no case had a table shorter than 8 clusters / a "
                                 "B5 prim table that is not padded")

    def free_camera_tables(self, env):
        from megaverse_tpu_torch.env import custom_camera_tables
        eye, yaw, pitch = free_camera_view(env)
        return {(h, w): custom_camera_tables(env.scenario, env.state, eye, yaw, pitch,
                                             width=w, height=h)
                for h, w in FREE_CAMERA_SIZES}

    def free_camera_compare(self, label, env) -> None:
        """The free camera of env 0 through B1 at every size of
        FREE_CAMERA_SIZES against its plain version: at most 1 per colour
        channel on fewer than 1e-4 of the pixels."""
        RC = self.RC
        report = {}
        for (h, w), tabs in self.free_camera_tables(env).items():
            img = RC.render_packed(**tabs)
            plain = RC.render_packed_plain(**tabs)
            torch.cuda.synchronize()
            worst, frac = channel_diff(img, plain)
            self.max_err["render_b1"] = max(self.max_err["render_b1"], worst)
            if tuple(img.shape) != (1, 1, h, w) or not (worst <= 1 and frac < TOL_FRACTION):
                raise AssertionError(f"{label}: free camera {h}x{w} {tuple(img.shape)} "
                                     f"disagrees with its plain version (max {worst}, "
                                     f"fraction {frac})")
            if torch.unique(img).numel() < 8:
                raise AssertionError(f"{label}: free camera {h}x{w} is (nearly) constant")
            report[f"{h}x{w}"] = {"max_channel_diff": worst, "fraction_differing": frac,
                                  "rows": int(tabs["prims"].shape[1]),
                                  "distinct_colours": int(torch.unique(img).numel())}
        emit({"phase": "free_camera_vs_plain", "case": label, "form": "render_b1",
              "plain_tolerance": "1 level on < 1e-4", "sizes": report})

    def free_camera_main(self, label, env) -> None:
        """`render_custom_camera` (the user's entry point) of env 0 at every
        size of FREE_CAMERA_SIZES, launch counts zeroed before and read after:
        one B1 launch per image and no other form."""
        from megaverse_tpu_torch.env import render_custom_camera
        RC = self.RC
        eye, yaw, pitch = free_camera_view(env)
        torch.cuda.synchronize()
        self.reset_counts()
        t0 = time.perf_counter()
        images = [render_custom_camera(env.scenario, env.state, eye, yaw, pitch,
                                       width=w, height=h) for h, w in FREE_CAMERA_SIZES]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = form_counts(RC)
        for (h, w), img in zip(FREE_CAMERA_SIZES, images):
            if img.dtype != torch.uint8 or tuple(img.shape) != (h, w, 3) \
                    or img.device != self.dev or torch.unique(img).numel() < 8:
                raise AssertionError(f"{label}: free camera {h}x{w}: {img.dtype} "
                                     f"{tuple(img.shape)} on {img.device}")
        want = len(FREE_CAMERA_SIZES)
        for k, n in counts.items():
            if n != (want if k == "render_b1" else 0):
                raise AssertionError(f"{label}: launches {counts}, expected {want} of "
                                     "render_b1 and no other")
            self.launches[k] += n
        self.launches_by_part["free_camera"] = counts["render_b1"]
        emit({"phase": "main_path", "run": label, "scenario": env.scenario.name,
              "sizes": [list(s) for s in FREE_CAMERA_SIZES], "launches": counts,
              "seconds": seconds, "gpu": self.smi})

    def classes_main(self, label, env, chunk=16) -> None:
        """Render size classes switched on for a driven env (no new reset):
        its state rendered with and without classes must be bit-equal; one
        timed chunk with classes on must launch B2 once per class group and
        step; the render's and the B2 kernels' milliseconds with classes on
        and off."""
        from megaverse_tpu_torch.env import render_tables, render_view, render_view_index
        RC = self.RC
        env.flush()
        plain = env.render()
        render_off = time_cuda(env.render, 5)
        tabs_off = render_tables(env.scenario, env.state, bucket=env._bucket,
                                 mode=env.render_mode)
        b2_off = time_cuda(lambda: RC.render_packed(height=72, width=128, **tabs_off), 10)
        env.set_render_classes(True)
        groups = [int(idx.shape[0]) for _, idx in env._cls_groups]
        classed = env.render()
        torch.cuda.synchronize()
        if not torch.equal(classed, plain):
            raise AssertionError(f"{label}: the classed render differs from the unclassed "
                                 f"one on {int((classed != plain).sum().item())} pixels")
        render_on = time_cuda(env.render, 5)
        # the kernel alone, group by group, at its class's table size
        view = render_view(env.state)
        b2_on = []
        for k, idx in env._cls_groups:
            box_rows, seg_rows = env._class_ladder[k]
            seg = seg_rows if env.scenario.cfg.prop_segments else seg_rows[0]
            tabs = render_tables(env.scenario, render_view_index(view, idx),
                                 bucket=(box_rows, seg), mode=env.render_mode)
            b2_on.append(time_cuda(lambda t=tabs: RC.render_packed(height=72, width=128, **t),
                                   10))
        pool = self.action_pool(env.num_envs, env.num_agents_per_env)
        torch.cuda.synchronize()
        self.reset_counts()
        t0 = time.perf_counter()
        obs, _, csums = env.step_many(pool, chunk)
        _ = int(csums[-1].item())
        seconds = time.perf_counter() - t0
        counts = form_counts(RC)
        env.flush()
        torch.cuda.synchronize()
        env.set_render_classes(False)
        rate = env.num_envs * env.num_agents_per_env * chunk / seconds
        emit({"phase": "main_path", "run": label, "scenario": env.scenario.name,
              "envs": env.num_envs, "agents": env.num_agents_per_env, "steps": chunk,
              "launches": counts, "class_groups": groups, "obs_per_sec": rate,
              "ms_per_step": 1e3 * seconds / chunk, "render_ms_classes_off": render_off,
              "render_ms_classes_on": render_on, "b2_ms_classes_off": b2_off,
              "b2_ms_classes_on": sum(b2_on), "b2_ms_per_group": b2_on,
              "classed_equals_unclassed": True, "gpu": self.smi,
              "note": "first reading, not a claim; one chunk"})
        self.check_run(label, env, counts, "render_b2", len(groups) * chunk, obs, ticks=chunk)
        self.launches_by_part["classes"] = counts["render_b2"]
        self.obs_per_s[label] = rate

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
        RC = self.RC
        env = VectorEnv(name, envs, agents, seed=42, params=params)
        pool = self.action_pool(envs, agents)
        self.reset_counts()
        t0 = time.perf_counter()
        obs = env.reset()
        torch.cuda.synchronize()
        reset_seconds = time.perf_counter() - t0
        reset_layout_seconds = env.layout_seconds
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
        counts = form_counts(RC)
        steps = chunk * chunks
        # a first reading: chunks after the first (the first pays one-off costs)
        timed = secs[1:] or secs
        rate = envs * agents * chunk * len(timed) / sum(timed)
        n_done = int(any_done.sum().item())
        extra = {}
        row_bits = env.scenario.render_row_mask(env.state)
        if row_bits is not None:
            # (env, agent) pairs whose PVS row mask hides some row at the end
            extra["pvs_mask_active_share"] = (~row_bits.all(dim=-1)).float().mean().item()
        emit({"phase": "main_path", "run": label, "scenario": name, "envs": envs,
              "agents": agents, "steps": steps, "launches": counts,
              "render_mode": {k: v for k, v in vars(env.render_mode).items()},
              "bucket": env._bucket,
              "obs_per_sec": rate, "ms_per_step": 1e3 * sum(timed) / (chunk * len(timed)),
              "chunk_seconds": secs, "envs_done": n_done,
              "refills": env.num_refills, "refilled_envs": env.num_refilled_envs,
              "reset_seconds": reset_seconds,
              "layout_seconds_reset": reset_layout_seconds,
              "layout_seconds_total": env.layout_seconds,
              "layouts_generated": 2 * envs + env.num_refilled_envs, **extra,
              "gpu": self.smi, "note": "first reading, not a claim"})
        self.check_run(label, env, counts, form, 1 + steps, obs, ticks=steps)
        if expect_refill and (n_done < 1 or env.num_refilled_envs < 1):
            raise AssertionError(f"{label}: no auto-reset/refill happened "
                                 f"(done {n_done}, refilled {env.num_refilled_envs})")
        self.obs_per_s[label] = rate
        env.close()
        return env if keep else None

    def check_run(self, label, env, counts, form, expected, obs, ticks=None) -> None:
        """`expected` launches of `form` and none of any other; with `ticks`,
        one masked copy per tick where the scenario defers its reset and none
        elsewhere; packed, non-constant observations; a finite state."""
        from megaverse_tpu_torch.env import should_defer_reset
        from megaverse_tpu_torch.types import tree_leaves
        for k, n in counts.items():
            if n != (expected if k == form else 0):
                raise AssertionError(f"{label}: launches {counts}, expected "
                                     f"{expected} of {form} and no other")
            self.launches[k] += n
        if ticks is not None:
            n = self.RC.LAUNCHES["masked_copy"]
            want = ticks if should_defer_reset(env.scenario) else 0
            if n != want:
                raise AssertionError(f"{label}: {n} masked copies, expected {want}")
            self.mc_launches += n
            n = self.RC.LAUNCHES["kcc"]
            if n != ticks:
                raise AssertionError(f"{label}: {n} KCC launches, expected {ticks}")
            self.kcc_launches += n
            n = self.RC.LAUNCHES["stacking"]
            want = ticks if env.scenario.name in STACKING_SCENES else 0
            if n != want:
                raise AssertionError(f"{label}: {n} stacking launches, expected {want}")
            self.stacking_launches += n
        shape = (env.num_envs, env.num_agents_per_env, 72, 128)
        if obs.dtype != torch.int32 or tuple(obs.shape) != shape:
            raise AssertionError(f"{label}: obs {obs.dtype} {tuple(obs.shape)}")
        if torch.unique(obs).numel() < 3:
            raise AssertionError(f"{label}: observations are constant")
        st = env.state
        for leaf in tree_leaves(st):
            if leaf.is_floating_point() and not torch.isfinite(leaf).all():
                raise AssertionError(f"{label}: non-finite values in the state")
        if not torch.isfinite(st.total_reward).all():
            raise AssertionError(f"{label}: rewards not finite")

    def drive_mode(self, label, name, env, form, chunk=16) -> None:
        """One step_many chunk + flush of a driven env under the render mode
        the environment variables now select, with the launch counts zeroed
        before and read after; the env goes back to its own mode."""
        from megaverse_tpu_torch.env import RenderMode
        RC = self.RC
        own = env.render_mode
        env.render_mode = RenderMode.from_env()
        pool = self.action_pool(env.num_envs, env.num_agents_per_env)
        torch.cuda.synchronize()
        self.reset_counts()
        t0 = time.perf_counter()
        obs, _, csums = env.step_many(pool, chunk)
        _ = int(csums[-1].item())
        seconds = time.perf_counter() - t0
        env.flush()
        torch.cuda.synchronize()
        counts = form_counts(RC)
        mode = {k: v for k, v in vars(env.render_mode).items()}
        env.render_mode = own
        rate = env.num_envs * env.num_agents_per_env * chunk / seconds
        emit({"phase": "main_path", "run": label, "scenario": name,
              "envs": env.num_envs, "agents": env.num_agents_per_env, "steps": chunk,
              "launches": counts, "render_mode": mode, "bucket": env._bucket,
              "obs_per_sec": rate, "ms_per_step": 1e3 * seconds / chunk,
              "chunk_seconds": [seconds], "refills": env.num_refills,
              "gpu": self.smi, "note": "first reading, not a claim; one chunk "
                                       "(first call of the form included)"})
        self.check_run(label, env, counts, form, chunk, obs, ticks=chunk)
        self.obs_per_s[label] = rate

    def main_path(self):
        from megaverse_tpu_torch.env import UNCULLED, render_tables
        tower = self.bench_main()
        empty = self.drive("empty_4096x1", "Empty", 4096, 1, 64, 2, keep=True)
        with ModeEnv(MEGAVERSE_NO_CLUSTER_CULL="1"):
            self.drive_mode("tower_1024x1_unculled", "TowerBuilding", tower, "render_b1")
        collect = self.drive("collect_1024x1", "Collect", 1024, 1, 64, 2, keep=True)
        # The other forms at the same width, on the Collect env just driven
        # (a new env per form would generate 2,048 more layouts on the host
        # each): one chunk of 16 steps in each mode, its launch counts zeroed
        # before and read after.
        with ModeEnv(MEGAVERSE_RENDER_MODE="super"):
            self.drive_mode("collect_1024x1_super", "Collect", collect, "render_b5")
            with ModeEnv(MEGAVERSE_NO_SUPERCLUSTERS="1"):
                self.drive_mode("collect_1024x1_tile_lists", "Collect", collect, "render_b4")
                with ModeEnv(MEGAVERSE_NO_CLUSTER_SORT="1"):
                    self.drive_mode("collect_1024x1_in_order", "Collect", collect, "render_b3")
        with ModeEnv(MEGAVERSE_MERGE_TILES="1"):
            self.drive_mode("collect_1024x1_merged", "Collect", collect, "render_b6")
        # render size classes and the free camera on the same env
        self.classes_main("collect_1024x1_classes", collect)
        self.free_camera_main("collect_1024x1_free_camera", collect)
        hard = self.drive("obstacleshard_1024x1", "ObstaclesHard", 1024, 1, 64, 2,
                          keep=True)
        # Four agents per env (the per-agent passes of the stacking component).
        # TowerBuilding episodes last episodeLengthSec + 4 s per movable box
        # (>= 4 boxes), so with 4 s the shortest is 20 s = 300 steps; with seed
        # 42 the first envs time out at step 480. 22 chunks of 24 steps (the
        # overlapped-refill path: 2 * 24 < 60) see them finish, restart from
        # the layout buffer and get their slots refilled.
        tower4 = self.drive("tower_256x4_short_episodes", "TowerBuilding", 256, 4, 24, 22,
                            params={"episodeLengthSec": 4.0}, expect_refill=True, keep=True)
        # The same for the other scenario states.
        # Collect episodes last episodeLengthSec + 2 s per reward diamond
        # (>= 1), so with 4 s the shortest is 6 s = 90 steps: 8 chunks of 24
        # steps (overlapped refill) see envs finish, restart from the layout
        # buffer and get their slots refilled.
        self.drive("collect_256x2_short_episodes", "Collect", 256, 2, 24, 8,
                   params={"episodeLengthSec": 4.0}, expect_refill=True)
        # Test is the Obstacles family with no obstacle platform and 6 s
        # episodes: every env restarts at step 90 (synchronous refill:
        # 2 * 64 >= 90).
        self.drive("test_256x1_short_episodes", "Test", 256, 1, 64, 3,
                   expect_refill=True)
        # The scenarios of the latest slice at the size bench.py times, then
        # Sokoban with 4 s episodes (60 steps; levels also end early when
        # solved): 8 chunks of 24 steps (overlapped refill: 2 * 24 < 60) see
        # envs finish, restart from the layout buffer and get refilled.
        new_envs = {name: self.drive(label, name, 1024, 1, 64, 2, keep=True)
                    for name, label in NEW_SCENES.items()}
        self.drive("sokoban_256x2_short_episodes", "Sokoban", 256, 2, 24, 8,
                   params={"episodeLengthSec": 4.0}, expect_refill=True)
        # The hex scenes at the size bench.py times, then HexExplore with 4 s
        # episodes (60 steps; HexMemory's last episodeLengthSec + 3 s per
        # good object): 8 chunks of 24 steps (overlapped refill) see envs
        # finish, restart from the layout buffer and get refilled.
        hex_envs = {name: self.drive(label, name, 1024, 1, 64, 2, keep=True)
                    for name, label in HEX_SCENES.items()}
        self.drive("hexexplore_256x2_short_episodes", "HexExplore", 256, 2, 24, 8,
                   params={"episodeLengthSec": 4.0}, expect_refill=True)
        # the kernels against the plain version once more, at the very shapes
        # and states the main path ended on; the forms this scenario's runs
        # went through also against their own plain version
        for label, env, plain_cases in (
                ("TowerBuilding_1024x1", tower, ("b2",)),
                ("Empty_4096x1", empty, ("b2",)),
                ("Collect_1024x1", collect, ("b2", "b3", "b4_tile", "b5")),
                ("ObstaclesHard_1024x1", hard, ("b2",))):
            tabs = render_tables(env.scenario, env.state, bucket=env._bucket, mode=UNCULLED)
            self.compare(f"{label}_main_path_state", tabs["cams"], tabs["prims"],
                         env.scenario.cfg.obs_height, tabs["ui_indicators"],
                         plain_cases=plain_cases)
        # every form against its own plain version, 0 levels apart
        for name, env in new_envs.items():
            tabs = render_tables(env.scenario, env.state, bucket=env._bucket, mode=UNCULLED)
            self.compare(f"{name}_1024x1_main_path_state", tabs["cams"], tabs["prims"],
                         env.scenario.cfg.obs_height, tabs["ui_indicators"], exact=True)
        for name, env in hex_envs.items():
            tabs = render_tables(env.scenario, env.state, bucket=env._bucket, mode=UNCULLED)
            self.compare(f"{name}_1024x1_main_path_state", tabs["cams"], tabs["prims"],
                         env.scenario.cfg.obs_height, tabs["ui_indicators"])
            self.pvs_check(f"{name}_1024x1_main_path_state", env)
        # the captured tick against the eager one, on these envs (phase 3b)
        self.capture_phase({"TowerBuilding": tower, "Empty": empty, "Collect": collect,
                            "ObstaclesHard": hard, **new_envs, **hex_envs})
        self.kcc_phase({"collect_1024x1": collect, "obstacleshard_1024x1": hard,
                        "hexmemory_1024x1": hex_envs["HexMemory"],
                        "tower_256x4_short_episodes": tower4})
        self.stacking_phase({"collect_1024x1": collect, "obstacleshard_1024x1": hard,
                             "rearrange_1024x1": new_envs["Rearrange"],
                             "tower_256x4_short_episodes": tower4})
        del tower4
        return tower, collect, {**new_envs, **hex_envs}

    def obstacles_variants(self) -> dict:
        """The Obstacles variants of OBSTACLES_VARIANTS at VARIANT_ENVS x 1
        under the default mode (B2): reset + 2 chunks of 64 + flush each, as
        `drive`; then, at the state each run ends on, every form (tiled and
        merged) exactly equal to B1 and each within the tolerance of its
        own plain version, and B2 timed there. Each env is dropped before
        the next is made (a 1024-env Obstacles state and its next layouts
        take gigabytes). Returns {scenario: (B2's case times, meta)}."""
        from megaverse_tpu_torch.env import UNCULLED, render_tables
        out = {}
        for name, label in OBSTACLES_VARIANTS.items():
            env = self.drive(label, name, VARIANT_ENVS, 1, 64, 2, keep=True)
            tabs = render_tables(env.scenario, env.state, bucket=env._bucket, mode=UNCULLED)
            self.compare(f"{name}_{VARIANT_ENVS}x1_main_path_state", tabs["cams"],
                         tabs["prims"], env.scenario.cfg.obs_height, tabs["ui_indicators"])
            cases, meta = self.time_forms(env, ("b2",))
            emit({"phase": "kernel_times", "scenario": name, **meta, "cases": cases})
            out[name] = (cases, meta)
            del env, tabs
            torch.cuda.empty_cache()
        return out

    # ------------------------------------------------------------- phase 4
    def train_update_check(self) -> None:
        """The learner's update on the card against the same update on the
        CPU, from the same parameters and batch (numpy seed 0), at full width:
        hidden 512, 72x128, 8 envs x 2 agents x 32 steps."""
        from megaverse_tpu_torch.rl import learner as L

        t_len, envs, agents, hidden = UPDATE_SHAPE
        inputs = update_check_inputs()
        params0 = inputs[-1]
        lr = L.TrainConfig().lr
        # (dtype, loss, gradients, parameters after one update, share of the
        # parameters allowed past that): see the module docstring
        for dtype, tol_loss, tol_grad, tol_param, tol_share in (
                (torch.float32, 1e-4, 2e-3, 1e-4, 1e-4),
                (torch.bfloat16, 1e-2, 2e-2, 1e-4, 1e-2)):
            out = {}
            for dev in (self.dev, torch.device("cpu")):
                learner, ls, batch = update_check_setup(dev, dtype, inputs)
                params = ls.params
                t0 = time.perf_counter()
                with torch.no_grad():
                    _, last_value, _ = learner._policy(params, ls.obs, ls.carry)
                    adv, ret = learner._gae(batch, last_value)
                _, _, grads = learner.loss_and_grads(params, batch, adv, ret)
                ls2, metrics = learner._update_from_batch(ls, batch)
                loss = float(metrics["loss"])
                out[dev.type] = dict(loss=loss, grads={k: g.cpu() for k, g in grads.items()},
                                     params={k: p.cpu() for k, p in ls2.params.items()},
                                     seconds=time.perf_counter() - t0)
            card, cpu = out[self.dev.type], out["cpu"]
            loss_err = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
            g_norm = torch.sqrt(sum((g.double() ** 2).sum() for g in cpu["grads"].values()))
            g_err = float(torch.sqrt(sum(((card["grads"][k].double() - g.double()) ** 2).sum()
                                         for k, g in cpu["grads"].items())) / g_norm)
            p_diff = torch.cat([(card["params"][k] - p).abs().flatten()
                                for k, p in cpu["params"].items()])
            p_err = p_diff.max().item()
            share = (p_diff > tol_param).float().mean().item()
            moved = max((p - params0[k]).abs().max().item() for k, p in card["params"].items())
            finite = all(bool(torch.isfinite(p).all()) for p in card["params"].values())
            emit({"phase": "train_update_vs_cpu", "dtype": str(dtype).split(".")[-1],
                  "shape": [t_len, envs, agents, 72, 128], "hidden": hidden,
                  "loss_card": card["loss"], "loss_cpu": cpu["loss"],
                  "loss_rel_err": loss_err, "grad_rel_err": g_err,
                  "grad_norm": float(g_norm), "params_max_abs_err": p_err,
                  "params_share_past_tol": share, "params": int(p_diff.numel()),
                  "params_moved": moved, "card_seconds": card["seconds"],
                  "cpu_seconds": cpu["seconds"],
                  "tolerances": [tol_loss, tol_grad, tol_param, tol_share], "gpu": self.smi})
            if not (np.isfinite(card["loss"]) and finite and moved > 0):
                raise AssertionError(f"train update {dtype}: non-finite or no movement")
            # one Adam step moves an entry by at most lr: no two runs differ
            # by more than 2 lr
            if (loss_err > tol_loss or g_err > tol_grad or share > tol_share
                    or p_err > 2 * lr + 1e-6):
                raise AssertionError(f"train update {dtype}: card vs CPU loss {loss_err}, "
                                     f"grads {g_err}, params {p_err} ({share} past {tol_param})")

    def train_run(self, label, run, extra=(), observer=None):
        """`rl.train.main` on `run` (env, num_envs, agents, updates) at the
        model's full width, rollout ROLLOUT, seed 42, into a temporary
        directory, with the launch counts zeroed before and read after:
        B2 launches == updates * ROLLOUT + one initial render per task and
        no other form, every task's metrics finite, the parameters moved
        from the learner's init, `updates` updates and the checkpoint at
        updates * ROLLOUT * num_envs env steps. Returns (summary, its line
        for the output, the checkpoint's path, the directory); the caller
        removes the directory."""
        import tempfile

        from megaverse_tpu_torch.convert import actor_critic_from_flax
        from megaverse_tpu_torch.models.actor_critic import ActorCritic
        from megaverse_tpu_torch.rl import train
        from megaverse_tpu_torch.rl.checkpoint import load_checkpoint
        RC = self.RC
        seed = 42
        tmp = tempfile.mkdtemp()
        argv = ["--env", run["env"], "--num_envs", str(run["num_envs"]),
                "--num_agents_per_env", str(run["agents"]), "--rollout", str(ROLLOUT),
                "--train_for_env_steps", str(run["updates"] * ROLLOUT * run["num_envs"]),
                "--seed", str(seed), *extra, "--train_dir", tmp]
        torch.cuda.synchronize()
        memory_before = torch.cuda.memory_allocated(self.dev)
        self.reset_counts()
        t0 = time.perf_counter()
        if train.main(argv, observer=observer) != 0:
            raise AssertionError(f"{label}: rl.train.main did not return 0")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = form_counts(RC)
        out_dir = os.path.join(tmp, "default")
        with open(os.path.join(out_dir, "train_summary.json")) as f:
            summary = json.load(f)
        ckpt_path = os.path.join(out_dir, "checkpoint.pkl")
        ckpt = load_checkpoint(ckpt_path)
        # the parameters the trainer started from: the first task's learner
        # init (flax's initializers from the task's seed, on the card)
        start = ActorCritic().to(self.dev)
        start.reset_parameters(torch.Generator(self.dev).manual_seed(seed))
        trained = actor_critic_from_flax(ckpt["params"])
        moved = max((trained[k] - v.cpu()).abs().max().item()
                    for k, v in start.state_dict().items())
        m = summary["metrics"]
        line = {"phase": label, "argv": argv[:-2], "tasks": summary["tasks"],
                "updates": summary["updates"], "env_steps": summary["env_steps"],
                "env_steps_per_s": summary["env_steps_per_s"],
                "samples_per_s": summary["samples_per_s"],
                "rollout_ms": summary["rollout_ms"], "update_ms": summary["update_ms"],
                "setup_seconds": summary["setup_seconds"],
                "layout_seconds": summary["layout_seconds"],
                "train_seconds": summary["seconds"], "main_seconds": wall,
                # the script's own tensors (the main path's envs) before the run
                "device_memory_before_bytes": memory_before,
                "device_memory_after_setup_bytes": summary["device_memory_after_setup_bytes"],
                "setup_peak_device_memory_bytes": summary["setup_peak_device_memory_bytes"],
                "peak_device_memory_bytes": summary["peak_device_memory_bytes"],
                "launches": counts, "loss": m["loss"], "entropy": m["entropy"],
                "reward_mean": m["reward_mean"], "params_moved": moved,
                "checkpoint_steps": ckpt["steps"], "gpu": self.smi,
                "note": "first reading, not a claim"}
        want = run["updates"] * ROLLOUT + len(summary["tasks"])
        for k, n in counts.items():
            if n != (want if k == "render_b2" else 0):
                raise AssertionError(f"{label}: launches {counts}, expected {want} of "
                                     "render_b2 and no other")
            self.launches[k] += n
        # one masked copy per rollout step of every task that defers its reset
        from megaverse_tpu_torch.env import should_defer_reset
        from megaverse_tpu_torch.scenarios import make_scenario
        tasks = summary["tasks"]
        defer = {n: should_defer_reset(make_scenario(n, num_agents=run["agents"]))
                 for n in set(tasks)}
        want_mc = sum(ROLLOUT for it in range(summary["updates"])
                      if defer[tasks[it % len(tasks)]])
        line["masked_copy_launches"] = self.RC.LAUNCHES["masked_copy"]
        if line["masked_copy_launches"] != want_mc:
            raise AssertionError(f"{label}: {line['masked_copy_launches']} masked copies, "
                                 f"expected {want_mc}")
        metrics = [m, *summary["task_metrics"].values()]
        if (not all(np.isfinite(v) for mm in metrics for v in mm.values()) or moved <= 0
                or set(summary["task_metrics"]) != set(summary["tasks"])):
            raise AssertionError(f"{label}: metrics {summary['task_metrics']}, parameters "
                                 f"moved {moved}")
        if (summary["updates"] != run["updates"]
                or ckpt["steps"] != run["updates"] * ROLLOUT * run["num_envs"]):
            raise AssertionError(f"{label}: {summary['updates']} updates, checkpoint at "
                                 f"{ckpt['steps']} steps")
        return summary, line, ckpt_path, tmp

    def enjoy_run(self, label, run, ckpt_path) -> None:
        """`rl.enjoy.main` plays the checkpoint on `run`'s scenario and
        agents for ENJOY_STEPS steps: B2 launches == steps + 1, no other."""
        from megaverse_tpu_torch.rl import enjoy
        RC = self.RC
        torch.cuda.synchronize()
        self.reset_counts()
        t0 = time.perf_counter()
        if enjoy.main(["--env", run["env"], "--num_agents_per_env", str(run["agents"]),
                       "--checkpoint", ckpt_path, "--episodes", "1",
                       "--max_steps", str(ENJOY_STEPS)]) != 0:
            raise AssertionError(f"{label}: rl.enjoy.main did not return 0")
        torch.cuda.synchronize()
        counts = form_counts(RC)
        emit({"phase": label, "env": run["env"], "agents": run["agents"],
              "steps": ENJOY_STEPS, "launches": counts, "seconds": time.perf_counter() - t0})
        for k, n in counts.items():
            if n != (ENJOY_STEPS + 1 if k == "render_b2" else 0):
                raise AssertionError(f"{label}: launches {counts}, expected "
                                     f"{ENJOY_STEPS + 1} of render_b2 and no other")
            self.launches[k] += n

    def train_path(self) -> None:
        """`rl.train.main` on Collect 512 x 2 (TRAIN_RUN) for 3 updates, then
        `rl.enjoy.main` on its checkpoint."""
        import shutil
        _, line, ckpt_path, tmp = self.train_run("train", TRAIN_RUN)
        emit(line)
        try:
            self.enjoy_run("enjoy", TRAIN_RUN, ckpt_path)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def train_4ag(self) -> None:
        """Four agents per env (TRAIN_4AG, megaverse_4ag's width) with
        team-spirit annealing over two updates' env steps: after every
        update the shaping column equals min(1, steps done / max steps), the
        reference's formula (megaverse_tpu/rl/train.py:326-330); then
        `rl.enjoy.main` plays the checkpoint with four agents."""
        import shutil
        run = TRAIN_4AG
        per_update = ROLLOUT * run["num_envs"]
        max_steps = 2 * per_update
        column = []

        def observer(it, tasks, metrics):
            task = tasks[0]
            col = task.shaping[:, :, task.spirit_col]
            column.append(float(col[0, 0]))
            if it and not bool((col == min(1.0, it * per_update / max_steps)).all()):
                raise AssertionError(f"train_4ag: team spirit {col.unique().tolist()} after "
                                     f"update {it}, expected "
                                     f"{min(1.0, it * per_update / max_steps)}")

        _, line, ckpt_path, tmp = self.train_run(
            "train_4ag", run, observer=observer,
            extra=("--megaverse_increase_team_spirit", "1",
                   "--megaverse_max_team_spirit_steps", str(max_steps)))
        emit(dict(line, max_team_spirit_steps=max_steps, team_spirit_after_update=column))
        try:
            self.enjoy_run("enjoy_4ag", run, ckpt_path)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def train_multitask(self) -> None:
        """Multitask training (MULTITASK, megaverse_multitask8's width: the
        eight Megaverse-8 tasks x 1,024 envs, one shared policy and Adam
        state) for one update per task: besides `train_run`'s checks, the
        tasks run in gym_env.MEGAVERSE8 order, and each task's envs advance
        only on its own turn, by ROLLOUT frames (an env that reset during
        the rollout restarts its count: fewer than ROLLOUT)."""
        import shutil

        from megaverse_tpu_torch.gym_env import MEGAVERSE8
        run = MULTITASK
        frames = {}
        stepped = []

        def observer(it, tasks, metrics):
            now = {t.name: t.ls.env_state.num_frames.cpu() for t in tasks}
            if it:
                k = (it - 1) % len(tasks)
                stepped.append(tasks[k].name)
                for i, t in enumerate(tasks):
                    old, new = frames[t.name], now[t.name]
                    if i != k and not torch.equal(old, new):
                        raise AssertionError(f"train_multitask: {t.name} advanced on "
                                             f"{tasks[k].name}'s turn")
                    if i == k and not (((new == old + ROLLOUT) | (new < ROLLOUT)).all()
                                       and bool((new == old + ROLLOUT).any())):
                        raise AssertionError(f"train_multitask: {t.name}'s frames went "
                                             f"{old.tolist()[:8]} -> {new.tolist()[:8]}")
            frames.update(now)

        summary, line, _, tmp = self.train_run("train_multitask", run, observer=observer)
        shutil.rmtree(tmp, ignore_errors=True)
        n = len(summary["tasks"])
        per_task = {name: {"rollout_ms": summary["rollout_ms"][i::n],
                           "update_ms": summary["update_ms"][i::n],
                           "loss": summary["task_metrics"][name]["loss"],
                           "entropy": summary["task_metrics"][name]["entropy"],
                           "reward_mean": summary["task_metrics"][name]["reward_mean"]}
                    for i, name in enumerate(summary["tasks"])}
        emit(dict(line, per_task=per_task, stepped=stepped))
        if summary["tasks"] != list(MEGAVERSE8) or stepped != list(MEGAVERSE8) * (
                run["updates"] // n):
            raise AssertionError(f"train_multitask: tasks {summary['tasks']}, stepped "
                                 f"{stepped}")

    # ------------------------------------------------------------- phase 6
    def parallel_world_one(self) -> None:
        """NCCL at world size 1 (the MEGAVERSE_COORDINATOR variables through
        `parallel.maybe_initialize_distributed`): one `ParallelLearner` update
        of the learner check's batch (float32, hidden 512) is bit-equal to
        the plain learner's update, with cuDNN held deterministic."""
        import tempfile

        from megaverse_tpu_torch.parallel import (ParallelLearner, maybe_initialize_distributed,
                                                  shutdown_distributed, world)
        inputs = update_check_inputs()
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            with tempfile.TemporaryDirectory() as tmp, ModeEnv(
                    MEGAVERSE_COORDINATOR=f"file://{os.path.join(tmp, 'init')}",
                    MEGAVERSE_NUM_PROCESSES="1", MEGAVERSE_PROCESS_ID="0"):
                if not maybe_initialize_distributed(device=self.dev):
                    raise AssertionError("parallel: no process group was made")
                try:
                    backend = torch.distributed.get_backend()
                    learner, ls, batch = update_check_setup(self.dev, torch.float32, inputs)
                    plain = [learner._update_from_batch(ls, batch)[0].params for _ in range(2)]
                    t0 = time.perf_counter()
                    par = ParallelLearner(learner)._update_from_batch(ls, batch)[0].params
                    torch.cuda.synchronize()
                    seconds = time.perf_counter() - t0
                    ranks = world()
                finally:
                    shutdown_distributed()
        finally:
            torch.backends.cudnn.deterministic = deterministic
        same = lambda a, b: all(torch.equal(a[k], b[k]) for k in a)
        emit({"phase": "parallel_world_one", "backend": backend, "rank_world": list(ranks),
              "plain_repeats_equal": same(plain[0], plain[1]),
              "parallel_equals_plain": same(par, plain[0]), "update_seconds": seconds,
              "gpu": self.smi})
        if backend != "nccl" or not same(par, plain[0]):
            raise AssertionError(f"parallel: the {backend} world-size-1 update differs "
                                 "from the plain learner's")

    def parallel_two_ranks(self) -> None:
        """Two gloo ranks on the one card (`entry.run_ranks`; NCCL refuses
        two ranks on one device): their VectorEnv sampling of Collect 512 x 2
        (256 envs each), joined in rank order, equals one process's bit for
        bit; after one training step of the trainer's task (rollout 32,
        hidden 512, gradients averaged over the ranks) the two replicas'
        parameters are bit-equal. The line also gives each rank's all-reduce
        of the gradients' size, timed on its own after the update."""
        from megaverse_tpu_torch import entry
        t0 = time.perf_counter()
        outputs = entry.run_ranks(dict(devices=PARALLEL_DEVICES, backend="gloo",
                                       sampling=[PARALLEL_SAMPLING], train=PARALLEL_TRAIN))
        ranks_seconds = time.perf_counter() - t0
        label = PARALLEL_SAMPLING["label"]
        single = entry.sample(PARALLEL_SAMPLING, self.dev)
        for key in ("obs", "reward", "done"):
            if not torch.equal(entry.gathered(outputs, label, key), single[key]):
                raise AssertionError(f"parallel: the two ranks' {key} differ from one "
                                     "process's")
        if not entry.replicas_equal(outputs):
            raise AssertionError("parallel: the replicas' parameters differ after the update")
        # per rank: reset + steps of the sampling, the task's first render +
        # one launch per rollout step
        want = 1 + PARALLEL_SAMPLING["steps"] + 1 + PARALLEL_TRAIN["rollout"]
        launches = 0
        for r, o in enumerate(outputs):
            counts = {k: o[label]["launches"][k] + o["train"]["launches"][k] for k in self.launches}
            if any(n != (want if k == "render_b2" else 0) for k, n in counts.items()):
                raise AssertionError(f"parallel: rank {r} launches {counts}, expected {want} "
                                     "of render_b2 and no other")
            launches += counts["render_b2"]
        self.launches["render_b2"] += launches
        self.launches_by_part["parallel_ranks"] = launches
        train = [o["train"] for o in outputs]
        slowest = max(t["rollout_ms"] + t["update_ms"] for t in train) / 1e3
        env_steps = PARALLEL_TRAIN["num_envs"] * PARALLEL_TRAIN["rollout"]
        emit({"phase": "parallel_two_ranks", "backend": "gloo", "devices": PARALLEL_DEVICES,
              "envs_per_rank": [t["envs"] for t in train],
              "sampling": {"frames": list(single["obs"].shape), "equal": True},
              "replicas_equal": True, "rollout_ms": [t["rollout_ms"] for t in train],
              "update_ms": [t["update_ms"] for t in train],
              "allreduce_ms": [t["allreduce_ms"] for t in train],
              "setup_seconds": [t["setup_s"] for t in train],
              "env_steps_per_s": env_steps / slowest,
              "samples_per_s": env_steps * PARALLEL_TRAIN["num_agents"] / slowest,
              "metrics": train[0]["metrics"], "launches_render_b2": launches,
              "ranks_seconds": ranks_seconds, "gpu": self.smi,
              "note": "first reading, not a claim; two ranks share one card"})

    # ------------------------------------------------------------- phase 3
    def bench_main(self):
        """The main path's TowerBuilding 1024 x 1 run through
        bench_torch.bench_scenario at BENCH_RUN, the env kept, with the
        launch counts zeroed before and read after; prints bench.py's line
        for the run. B2 launches == 1 reset + every step and no other form,
        the final state finite, the envs' last frames not all alike, obs/s
        positive."""
        import bench_torch
        RC = self.RC
        run = BENCH_RUN
        label = "tower_1024x1"
        torch.cuda.synchronize()
        self.reset_counts()
        t0 = time.perf_counter()
        res = bench_torch.bench_scenario(run["scenario"], run["num_envs"], run["num_agents"],
                                         chunk=run["chunk"], chunks=run["chunks"],
                                         keep_env=True)
        seconds = time.perf_counter() - t0
        counts = form_counts(RC)
        env = res.env
        bench_torch.emit(run["scenario"], run["num_envs"], res.obs_per_sec,
                         bench_torch.BASELINE_FPS.get(run["scenario"].lower(),
                                                      bench_torch.BASELINE_EMPTY_FPS))
        steps = run["chunk"] * (bench_torch.WARMUP_CHUNKS + run["chunks"])
        emit({"phase": "main_path", "run": label, "through": "bench_torch.bench_scenario",
              **run, "warmup_chunks": bench_torch.WARMUP_CHUNKS, "steps": steps,
              "launches": counts, "render_mode": vars(env.render_mode), "bucket": env._bucket,
              "obs_per_sec": res.obs_per_sec, "ms_per_step": 1e3 * res.seconds / (
                  run["chunk"] * run["chunks"]),
              "timed_obs": res.n_obs, "timed_seconds": res.seconds, "seconds": seconds,
              "refills": env.num_refills, "refilled_envs": env.num_refilled_envs,
              "layout_seconds_total": env.layout_seconds,
              "finite": res.finite, "gpu": self.smi, "note": "first reading, not a claim"})
        for k, n in counts.items():
            if n != (1 + steps if k == "render_b2" else 0):
                raise AssertionError(f"{label}: launches {counts}, expected {1 + steps} of "
                                     "render_b2 and no other")
            self.launches[k] += n
        if self.RC.LAUNCHES["masked_copy"] != steps:     # TowerBuilding defers its reset
            raise AssertionError(f"{label}: {self.RC.LAUNCHES['masked_copy']} masked "
                                 f"copies, expected {steps}")
        self.mc_launches += steps
        if self.RC.LAUNCHES["kcc"] != steps:
            raise AssertionError(f"{label}: {self.RC.LAUNCHES['kcc']} KCC launches, "
                                 f"expected {steps}")
        self.kcc_launches += steps
        if self.RC.LAUNCHES["stacking"] != steps:     # TowerBuilding stacks boxes
            raise AssertionError(f"{label}: {self.RC.LAUNCHES['stacking']} stacking "
                                 f"launches, expected {steps}")
        self.stacking_launches += steps
        if not res.finite:
            raise AssertionError(f"{label}: non-finite values in the final state")
        if np.unique(res.checksums).size < 2:
            raise AssertionError(f"{label}: every env's last frame sums to the same value")
        if not res.obs_per_sec > 0:
            raise AssertionError(f"{label}: obs/s {res.obs_per_sec}")
        self.launches_by_part["bench"] = counts["render_b2"]
        self.obs_per_s[label] = res.obs_per_sec
        env.close()
        return env

    # ------------------------------------------------------------- phase 3b
    @staticmethod
    def snapshot(env) -> dict:
        """Copies of what a tick reads and writes: the state, the layout
        buffer, the render bucket."""
        from megaverse_tpu_torch.types import tree_map
        return dict(state=tree_map(torch.clone, env.state),
                    next=tree_map(torch.clone, env.next_scenes), bucket=env._bucket)

    def ticks_from(self, env, snap, capture, actions, refill=None, sync_check=False,
                   interlude=None):
        """Restore `snap` into the env's bound buffers, then tick through
        `actions` (int32 [K, B, A] on the card) eagerly or captured (graphs
        dropped first: the first tick of a key warms it, the next captures
        it). `refill` = (tick, slot indices, layouts, bucket): at that tick
        the layouts are scattered into the buffer in place and the bucket
        set (a new graph key). With `sync_check` every eager tick runs under
        set_sync_debug_mode("error"). `interlude` = (tick, fn): fn() runs
        before that tick. Returns (obs per tick, dones per tick, the final
        state, graphs captured)."""
        from megaverse_tpu_torch.types import tree_copy_, tree_map, tree_scatter_
        ticks = env._ticks
        ticks.capture = capture
        ticks.drop()
        tree_copy_(env.state, snap["state"])
        tree_copy_(env.next_scenes, snap["next"])
        env._bucket = snap["bucket"]
        captures = ticks.captures
        obs_l, done_l = [], []
        for t in range(actions.shape[0]):
            if refill is not None and t == refill[0]:
                tree_scatter_(env.next_scenes, refill[1], refill[2])
                env._bucket = refill[3]
            if interlude is not None and t == interlude[0]:
                interlude[1]()
            if sync_check:
                torch.cuda.set_sync_debug_mode("error")
            try:
                obs, _, done, _ = env._advance(actions[t])
            finally:
                torch.cuda.set_sync_debug_mode("default")
            obs_l.append(obs.clone())
            done_l.append(done.clone())
        torch.cuda.synchronize()
        ticks.capture = True
        return obs_l, done_l, tree_map(torch.clone, env.state), ticks.captures - captures

    def capture_check(self, label, env, ticks=CAPTURE_TICKS, refill=True, mode=None):
        """`ticks` ticks of a driven env from one snapshot, eager (under
        set_sync_debug_mode("error")) and then captured: every obs and done
        of every tick and every leaf of the final state bit for bit equal;
        with `refill`, the first CAPTURE_EARLY envs time out at the second
        tick, layouts are scattered into the next CAPTURE_EARLY envs' slots
        and the bucket grows at tick CAPTURE_REFILL_AT (two captures), and
        those envs time out after it. `mode` renders with another form.
        The env keeps the captured run's end state. Returns the line."""
        from megaverse_tpu_torch.env import should_defer_reset
        from megaverse_tpu_torch.types import tree_leaves
        from megaverse_tpu_torch.vector_env import refill_slot_rung
        own_mode = env.render_mode
        if mode is not None:
            env.render_mode = mode
        env.flush()
        torch.cuda.synchronize()
        snap = self.snapshot(env)
        dt = env.scenario.cfg.dt
        n = CAPTURE_EARLY
        lens, secs = snap["state"].episode_len_sec, snap["state"].episode_sec
        plan = None
        if refill:
            secs[:n] = lens[:n] - 1.5 * dt
            secs[n:2 * n] = lens[n:2 * n] - (CAPTURE_REFILL_AT + 2.5) * dt
            idx = np.arange(n, 2 * n)
            slots = refill_slot_rung(n, env.num_envs)
            layouts = env._generate_batch(idx.tolist(), pad_to=slots)
            slot_idx = np.concatenate([idx, np.full((slots - n,), env.num_envs)])
            bucket = (snap["bucket"][0] + 8, snap["bucket"][1])
            plan = (CAPTURE_REFILL_AT, slot_idx, layouts, bucket)
        pool = torch.from_numpy(self.action_pool(env.num_envs, env.num_agents_per_env)
                                [:ticks]).to(self.dev)
        launches0 = dict(self.RC.LAUNCHES)
        t0 = time.perf_counter()
        eager = self.ticks_from(env, snap, False, pool, plan, sync_check=True)
        eager_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        captured = self.ticks_from(env, snap, True, pool, plan)
        captured_s = time.perf_counter() - t0
        launches = {k: v - launches0[k] for k, v in self.RC.LAUNCHES.items()
                    if v != launches0[k]}
        env.render_mode = own_mode
        for t in range(ticks):
            if not torch.equal(eager[0][t], captured[0][t]):
                raise AssertionError(f"{label}: tick {t}: captured obs differ from eager on "
                                     f"{int((eager[0][t] != captured[0][t]).sum())} pixels")
            if not torch.equal(eager[1][t], captured[1][t]):
                raise AssertionError(f"{label}: tick {t}: captured dones differ")
        for i, (a, b) in enumerate(zip(tree_leaves(eager[2]), tree_leaves(captured[2]))):
            if not torch.equal(a, b):
                raise AssertionError(f"{label}: state leaf {i} differs after {ticks} ticks")
        dones = [int(d.sum()) for d in captured[1]]
        want_captures = 2 if refill else 1
        if captured[3] != want_captures or eager[3] != 0:
            raise AssertionError(f"{label}: {captured[3]} captures, expected {want_captures}")
        if refill and (sum(dones[:CAPTURE_REFILL_AT]) < n or sum(dones[CAPTURE_REFILL_AT:]) < n):
            raise AssertionError(f"{label}: dones per tick {dones}: the forced time-outs "
                                 "did not happen")
        mc = launches.get("masked_copy", 0)
        if mc != (2 * ticks if should_defer_reset(env.scenario) else 0):
            raise AssertionError(f"{label}: {mc} masked copies in 2 x {ticks} ticks")
        if launches.get("kcc", 0) != 2 * ticks:
            raise AssertionError(f"{label}: {launches.get('kcc', 0)} KCC launches in "
                                 f"2 x {ticks} ticks")
        line = {"phase": "capture_vs_eager", "run": label, "scenario": env.scenario.name,
                "envs": env.num_envs, "agents": env.num_agents_per_env, "ticks": ticks,
                "render_mode": vars(env.render_mode if mode is None else mode),
                "refill_at": CAPTURE_REFILL_AT if refill else None, "dones_per_tick": dones,
                "captures": captured[3], "launches_both_runs": launches,
                "eager_seconds": eager_s, "captured_seconds": captured_s,
                "equal": "obs, dones and every state leaf, bit for bit",
                "eager_ticks_under_sync_debug_error": True, "gpu": self.smi}
        emit(line)
        return line

    def constants_check(self, label, env, ticks=4, at=3) -> None:
        """A replay reads the render's cached constants by address and never
        calls their caches: `ticks` ticks from one snapshot, eager and then
        captured (tick 0 warms, tick 1 captures, the rest replay), with
        CACHE_SIZES other free-camera frame sizes rendered (their constants
        and tile bounds cached) and the freed small blocks of the allocator
        written over before tick `at`: obs, dones and every state leaf bit
        for bit."""
        from megaverse_tpu_torch.env import render_custom_camera
        from megaverse_tpu_torch.types import tree_leaves
        RC = self.RC
        eye, yaw, pitch = free_camera_view(env)

        def interlude():
            for i in range(1, CACHE_SIZES + 1):
                h, w = 40 + 8 * i, 96 + 32 * i
                render_custom_camera(env.scenario, env.state, eye, yaw, pitch,
                                     width=w, height=h)
                RC._tile_dir_bounds_on(h, w, RC.TILE_H, RC.TILE_W, str(self.dev))
            junk = [torch.full((n,), -1, dtype=torch.int32, device=self.dev)
                    for n in range(128, 16384, 128)]
            del junk

        env.flush()
        torch.cuda.synchronize()
        snap = self.snapshot(env)
        pool = torch.from_numpy(self.action_pool(env.num_envs, env.num_agents_per_env)
                                [:ticks]).to(self.dev)
        eager = self.ticks_from(env, snap, False, pool, interlude=(at, interlude))
        captured = self.ticks_from(env, snap, True, pool, interlude=(at, interlude))
        if captured[3] != 1:
            raise AssertionError(f"{label}: {captured[3]} captures, expected 1")
        for t in range(ticks):
            if not (torch.equal(eager[0][t], captured[0][t])
                    and torch.equal(eager[1][t], captured[1][t])):
                raise AssertionError(f"{label}: tick {t}: the replay after {CACHE_SIZES} "
                                     "other frame sizes differs from the eager tick")
        for i, (a, b) in enumerate(zip(tree_leaves(eager[2]), tree_leaves(captured[2]))):
            if not torch.equal(a, b):
                raise AssertionError(f"{label}: state leaf {i} differs after {ticks} ticks")
        emit({"phase": "constants_outlive_other_sizes", "run": label,
              "scenario": env.scenario.name, "envs": env.num_envs, "ticks": ticks,
              "other_sizes_before_tick": at, "other_sizes": CACHE_SIZES,
              "equal": "obs, dones and every state leaf, bit for bit", "gpu": self.smi})

    def step_readings(self, label, env, chunk=16) -> None:
        """The step captured and eager in this call, on a driven env: ms and
        obs/s of a timed chunk each way (captured, eager, captured; each after
        two warm chunks of 4; a refill that grows the render bucket inside a
        timed chunk puts a warm tick and a capture in it), host
        operations per step (aten ops dispatched, counted with a dispatch
        mode over a chunk of 4, plus graph replays), device kernels per step
        and busy ms per step (torch.profiler over a chunk of 4), graphs
        captured, peak device memory."""
        from torch.profiler import ProfilerActivity, profile
        from torch.utils._python_dispatch import TorchDispatchMode

        class Count(TorchDispatchMode):
            n = 0

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                Count.n += 1
                return func(*args, **(kwargs or {}))

        pool = self.action_pool(env.num_envs, env.num_agents_per_env)
        ticks = env._ticks
        out = {"captured": [], "eager": []}
        per_mode = {}
        for capture in (True, False, True):
            ticks.capture = capture
            key = "captured" if capture else "eager"
            for _ in range(2):          # warm (and capture) this key, and the next
                _, _, cs = env.step_many(pool, 4)      # bucket a refill may bring
                cs[-1].item()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, cs = env.step_many(pool, chunk)
            cs[-1].item()
            seconds = time.perf_counter() - t0
            out[key].append(dict(ms_per_step=1e3 * seconds / chunk,
                                 obs_per_sec=env.num_envs * env.num_agents_per_env * chunk
                                 / seconds))
            if key in per_mode:
                continue
            replays = ticks.replays
            Count.n = 0
            with Count():
                _, _, cs = env.step_many(pool, 4)
            cs[-1].item()
            replays = ticks.replays - replays
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _, _, cs = env.step_many(pool, 4)
                cs[-1].item()
                torch.cuda.synchronize()
            kern = [k for k in prof.key_averages()
                    if getattr(k, "device_type", None) == torch.autograd.DeviceType.CUDA]
            busy = sum(float(getattr(k, "self_device_time_total", 0.0)) for k in kern)
            per_mode[key] = dict(host_ops_per_step=Count.n / 4, replays_per_step=replays / 4,
                                 device_kernels_per_step=sum(int(k.count) for k in kern) / 4
                                 if kern else "not measured",
                                 device_busy_ms_per_step=1e-3 * busy / 4
                                 if kern else "not measured")
        ticks.capture = True
        env.flush()
        emit({"phase": "step_captured_vs_eager", "run": label, "scenario": env.scenario.name,
              "envs": env.num_envs, "agents": env.num_agents_per_env, "chunk": chunk,
              "timed": out, "per_step": per_mode, "captures": ticks.captures,
              "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
              "peak_device_memory_reserved_bytes": torch.cuda.max_memory_reserved(),
              "gpu": self.smi, "note": "first reading, not a claim"})

    def sync_free_tick(self, label, env) -> None:
        """One eager tick of a driven env under set_sync_debug_mode("error"):
        no host synchronisation anywhere in the step, its deferred reset or
        its render."""
        act = torch.from_numpy(self.action_pool(env.num_envs, env.num_agents_per_env)[0]
                               ).to(self.dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            env._ticks.run(act, render=True, fmt=env.obs_format, bucket=env._bucket,
                           mode=env.render_mode, eager=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        emit({"phase": "sync_free_tick", "run": label, "scenario": env.scenario.name,
              "envs": env.num_envs, "sync_debug_mode": "error", "passed": True})

    def masked_copy_check(self, label, env) -> None:
        """The masked-copy kernel against its plain version on a driven env's
        layout leaves (state <- next layouts) with none, MASKED_COPY_DONE and
        all envs done: bit for bit; then both timed as replays of a graph of
        their launches (`time_graph`: device time, as in the tick's graph),
        with the bound (the done envs' rows read once and written once over
        the card's memory rate)."""
        from megaverse_tpu_torch.env import deferred_leaves
        from megaverse_tpu_torch.types import tree_map
        MC = self.MC
        scen_fields = env.scenario.deferred_scen_fields
        src = deferred_leaves(env.next_scenes, scen_fields)
        base = [x.clone() for x in deferred_leaves(env.state, scen_fields)]
        b = env.num_envs
        rng = np.random.default_rng(0)
        patterns = {"none": np.zeros(b, bool), "all": np.ones(b, bool)}
        some = np.zeros(b, bool)
        some[rng.choice(b, MASKED_COPY_DONE, replace=False)] = True
        patterns[f"{MASKED_COPY_DONE}_done"] = some
        row_bytes = MC.bytes_moved(src, 1) // 2
        cases = {}
        for name, mask in patterns.items():
            done = torch.from_numpy(mask).to(self.dev)
            got = [x.clone() for x in base]
            want = [x.clone() for x in base]
            MC.masked_copy_(got, src, done)
            MC.masked_copy_plain_(want, src, done)
            torch.cuda.synchronize()
            err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
            for i, (g, w) in enumerate(zip(got, want)):
                if not torch.equal(g, w):
                    raise AssertionError(f"{label}: masked copy leaf {i} ({name} done) "
                                         f"differs from its plain version (max {err})")
            nb = MC.bytes_moved(src, int(mask.sum()))
            cases[name] = dict(
                envs_done=int(mask.sum()), bytes=nb, max_abs_err=err,
                ms=time_graph(lambda: MC.masked_copy_(got, src, done), 20),
                plain_ms=time_graph(lambda: MC.masked_copy_plain_(want, src, done), 3),
                bound_ms=1e3 * nb / HBM_BYTES_PER_S, bound_by="bytes")
            del got, want
        main = cases[f"{MASKED_COPY_DONE}_done"]
        self.mc_row = {"shape": f"{label}, {MASKED_COPY_DONE} of {b} envs done",
                       "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
                       "ms": main["ms"], "plain_ms": main["plain_ms"],
                       "bound_ms": main["bound_ms"], "bound_by": "bytes",
                       "ms_all_done": cases["all"]["ms"],
                       "plain_ms_all_done": cases["all"]["plain_ms"],
                       "bound_ms_all_done": cases["all"]["bound_ms"],
                       "ms_none_done": cases["none"]["ms"],
                       "row_bytes_per_env": row_bytes, "leaves": len(src)}
        emit({"phase": "masked_copy_vs_plain", "run": label, "scenario": env.scenario.name,
              "envs": b, "leaves": len(src), "row_bytes_per_env": row_bytes,
              "cases": cases, "equal": "bit for bit", "gpu": self.smi})
        del base
        torch.cuda.empty_cache()

    def kcc_check(self, label, env) -> None:
        """The KCC kernel (`K.physics_step` on the card) against its plain
        version (`K.physics_step_plain`: player_step, then
        resolve_agent_collisions) on one tick from a driven env's end state:
        the agents after that tick's controls (the action pool's first row)
        and the scenario's preStep, as `env_step` hands them to the physics.
        pos, vvel and hvel bit for bit, jumping and on_ground equal, one
        launch. Both timed as replays of a graph of their launches
        (`time_graph`), with the bound: each agent's row read and written
        once, the column words of its 3 x 3 window and its env's walls read
        once, over the card's memory rate. The line also counts what the
        tick exercised: agents the slide held back, agents the walls pushed
        (player_step with and without them), agents pushed by other agents."""
        import megaverse_tpu_torch.constants as C
        from megaverse_tpu_torch.ops import kcc as K
        from megaverse_tpu_torch.ops import physics as P
        from megaverse_tpu_torch.types import tree_map
        env.flush()
        scen, cfg = env.scenario, env.scenario.cfg
        dt = cfg.dt
        state = tree_map(torch.clone, env.state)
        act = torch.from_numpy(self.action_pool(env.num_envs, env.num_agents_per_env)[0])
        act = act.to(self.dev)
        agents = P.apply_look(state.agents, act, dt, cfg.param(C.P_VERTICAL_LOOK_LIMIT))
        agents = P.apply_acceleration(agents, act, dt)
        state = scen.pre_physics(state.replace(agents=agents), act)
        agents, cols, obbs = state.agents, state.cols, scen.collision_obbs(state)
        before = self.RC.LAUNCHES["kcc"]
        got = K.physics_step(cfg.grid, agents, dt, cols, obbs)
        launched = self.RC.LAUNCHES["kcc"] - before
        want = K.physics_step_plain(cfg.grid, agents, dt, cols, obbs)
        stepped = P.player_step(cfg.grid, agents, dt, cols=cols, obbs=obbs)
        no_walls = P.player_step(cfg.grid, agents, dt, cols=cols)
        torch.cuda.synchronize()
        err = {k: float((getattr(got, k) - getattr(want, k)).abs().max())
               for k in ("pos", "vvel", "hvel")}
        for k in ("pos", "vvel", "hvel", "jumping", "on_ground"):
            if not torch.equal(getattr(got, k), getattr(want, k)):
                raise AssertionError(f"{label}: KCC kernel {k} differs from its plain "
                                     f"version (max {err})")
        if launched != 1:
            raise AssertionError(f"{label}: {launched} KCC launches for one call")
        free = agents.pos[..., 0::2] + agents.hvel[..., 0::2] * dt
        b, a = agents.pos.shape[:2]
        w = 0 if obbs is None else obbs.shape[1]
        nw = cols.shape[2]
        nbytes = 2 * b * a * (4 * 7 + 2) + 4 * b * a * 9 * nw + 4 * b * w * 7
        case = dict(
            envs=b, agents=a, walls=w, max_abs_err=max(err.values()), equal="bit for bit",
            slid=int((stepped.pos[..., 0::2] != free).any(-1).sum()),
            walls_pushed=int((stepped.pos != no_walls.pos).any(-1).sum()),
            agents_pushed=int((want.pos != stepped.pos).any(-1).sum()),
            landed=int(want.on_ground.sum()),
            ms=time_graph(lambda: K.physics_step(cfg.grid, agents, dt, cols, obbs), 20),
            plain_ms=time_graph(lambda: K.physics_step_plain(cfg.grid, agents, dt, cols,
                                                             obbs), 3),
            bytes=nbytes, bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bound_by="bytes")
        self.kcc_cases[label] = case
        emit({"phase": "kcc_vs_plain", "run": label, "scenario": scen.name, **case,
              "launches_main_path_so_far": self.kcc_launches, "gpu": self.smi})
        del state, agents, got, want, stepped, no_walls
        torch.cuda.empty_cache()

    def kcc_phase(self, envs: dict) -> None:
        """`kcc_check` on each run of KCC_RUNS (label -> its env)."""
        for label, *_ in KCC_RUNS:
            self.kcc_check(label, envs[label])

    @staticmethod
    def facing_boxes(state, zone, grid):
        """`state` with agent 0 of every even env facing an object that has
        nothing on top of it (inside the place zone where one is given): yaw
        and pitch 0, the body placed so the pickup spot (0, 0.02, -1) from it
        lies in the object's voxel. It picks the object up at the first tick
        and puts it back down at the second; the odd envs keep the driven
        state."""
        vobj, agents = state.vobj, state.agents
        b, nx, ny, nz = vobj.shape
        dev = vobj.device
        free = vobj != 0
        free[:, :, :-1] &= vobj[:, :, 1:] == 0
        if zone is not None:
            x = torch.arange(nx, device=dev).view(1, nx, 1, 1)
            z = torch.arange(nz, device=dev).view(1, 1, 1, nz)
            zn = [zone[:, k].view(b, 1, 1, 1) for k in range(4)]
            free &= (x >= zn[0]) & (x < zn[1]) & (z >= zn[2]) & (z < zn[3])
        flat = free.reshape(b, -1)
        moved = flat.any(dim=1) & (torch.arange(b, device=dev) % 2 == 0)
        i = flat.to(torch.int32).argmax(dim=1)
        cell = torch.stack([i // (ny * nz), (i // nz) % ny, i % nz], dim=-1).float()
        body = (cell.new_tensor(grid.origin) + (cell + 0.5) * grid.voxel_size
                + cell.new_tensor([0.0, -0.02, 1.0]))
        pos, yaw, pitch = agents.pos.clone(), agents.yaw.clone(), agents.pitch.clone()
        pos[:, 0] = torch.where(moved[:, None], body, pos[:, 0])
        yaw[:, 0] = torch.where(moved, 0.0, yaw[:, 0])
        pitch[:, 0] = torch.where(moved, 0.0, pitch[:, 0])
        return state.replace(agents=agents.replace(pos=pos, yaw=yaw, pitch=pitch))

    def stacking_check(self, label, env) -> None:
        """The stacking kernel (`object_stacking_step` on the card) against
        its plain version (`object_stacking_step_plain`) on two ticks from a
        driven env's end state, every agent pressing Interact (so agents that
        pick in the first tick place in the second), with the scene's place
        zone: every leaf either writes (`vobj` and `cols` in place; the prop
        table and `carried` anew), picked, placed and place_voxel bit for bit,
        one launch a call. Both timed as replays of a graph of their launches
        (`time_graph`) on a copy of the first tick's state, with the bound:
        the prop rows and `carried` read and written once, and per pass the
        agents' rows, the carried prop's row, the settle's cells and the
        pick's cells read once, over the card's memory rate."""
        import megaverse_tpu_torch.constants as C
        from megaverse_tpu_torch.scenarios import components as SC
        from megaverse_tpu_torch.scenarios.rearrange import PLACE_ZONE
        from megaverse_tpu_torch.types import device_const, tree_map
        env.flush()
        scen, grid = env.scenario, env.scenario.cfg.grid
        start = tree_map(torch.clone, env.state)
        b, a = start.agents.pos.shape[:2]
        act = torch.full((b, a), C.ACTION_INTERACT, dtype=torch.int32, device=self.dev)
        zone = {"TowerBuilding": lambda st: st.scen.zone,
                "Rearrange": lambda st: device_const(PLACE_ZONE, torch.int32, act).expand(b, 4),
                }.get(scen.name, lambda st: None)
        start = self.facing_boxes(start, zone(start), grid)
        got, want = start, tree_map(torch.clone, start)
        ticks = []
        for t in range(2):
            before = self.RC.LAUNCHES["stacking"]
            res = SC.object_stacking_step(grid, got, act, place_zone=zone(got))
            launched = self.RC.LAUNCHES["stacking"] - before
            ref = SC.object_stacking_step_plain(grid, want, act, place_zone=zone(want))
            torch.cuda.synchronize()
            if launched != 1:
                raise AssertionError(f"{label}: {launched} stacking launches for one call")
            pairs = {"vobj": (res.state.vobj, ref.state.vobj),
                     "cols": (res.state.cols, ref.state.cols),
                     "carried": (res.state.agents.carried, ref.state.agents.carried),
                     "picked": (res.picked, ref.picked), "placed": (res.placed, ref.placed),
                     "place_voxel": (res.place_voxel, ref.place_voxel),
                     **{f"props.{k}": (getattr(res.state.props, k), getattr(ref.state.props, k))
                        for k in ("pos", "scale", "flags", "type", "yaw", "color")}}
            for k, (x, y) in pairs.items():
                if not torch.equal(x, y):
                    diff = (x != y).reshape(b, -1).any(-1).nonzero().flatten()[:8].tolist()
                    raise AssertionError(f"{label}: stacking kernel {k} differs from its "
                                         f"plain version at tick {t} (envs {diff})")
            ticks.append(dict(picked=int(ref.picked.sum()), placed=int(ref.placed.sum()),
                              carrying=int((ref.state.agents.carried >= 0).sum())))
            got, want = res.state, ref.state
        if not ticks[0]["picked"] or not ticks[1]["placed"]:
            raise AssertionError(f"{label}: the two ticks did not both pick and place: {ticks}")
        timed = tree_map(torch.clone, start)
        p = start.props.pos.shape[1]
        table = 2 * b * (p * 25 + a * 2)
        per_pass = b * a * (4 + a * 20 + 25 + 16 * 6 + 3 * 2 + 6)
        nbytes = table + per_pass
        case = dict(
            envs=b, agents=a, props=p, ticks=ticks, equal="bit for bit",
            ms=time_graph(lambda: SC.object_stacking_step(grid, timed, act,
                                                          place_zone=zone(timed)), 20),
            plain_ms=time_graph(lambda: SC.object_stacking_step_plain(
                grid, timed, act, place_zone=zone(timed)), 3),
            bytes=nbytes, bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bound_by="bytes")
        self.stacking_cases[label] = case
        emit({"phase": "stacking_vs_plain", "run": label, "scenario": scen.name, **case,
              "launches_main_path_so_far": self.stacking_launches, "gpu": self.smi})
        del start, got, want, res, ref, timed
        torch.cuda.empty_cache()

    def stacking_phase(self, envs: dict) -> None:
        """`stacking_check` on each run of STACKING_RUNS (label -> its env)."""
        for label, *_ in STACKING_RUNS:
            self.stacking_check(label, envs[label])

    def capture_phase(self, envs: dict) -> None:
        """The captured tick against the eager one on the main path's 1024 x 1
        envs of CAPTURE_SCENES (a refill and a re-capture inside), one tick
        of every render form B1-B6 on the Collect env, a replay after
        CACHE_SIZES other frame sizes on it, the step captured and
        eager in this call on each, the masked copy against its plain
        version on ObstaclesHard's layouts, and one eager tick of every
        main-path env under set_sync_debug_mode("error")."""
        from megaverse_tpu_torch.env import RenderMode
        for name, env in envs.items():
            self.sync_free_tick(f"{name.lower()}_1024x1", env)
        for name in CAPTURE_SCENES:
            if name not in envs:
                continue
            env = envs[name]
            torch.cuda.reset_peak_memory_stats()
            self.capture_check(f"{name.lower()}_1024x1", env)
            self.step_readings(f"{name.lower()}_1024x1", env)
        if "Collect" in envs:
            forms = {"render_b1": RenderMode(cluster_cull=False), "render_b2": RenderMode(),
                     "render_b3": RenderMode(mode="super", cluster_sort=False),
                     "render_b4": RenderMode(mode="super", superclusters=False),
                     "render_b5": RenderMode(mode="super"),
                     "render_b6": RenderMode(merge_tiles=True)}
            for form, mode in forms.items():
                line = self.capture_check(f"collect_1024x1_{form}", envs["Collect"], ticks=2,
                                          refill=False, mode=mode)
                if line["launches_both_runs"].get(form) != 4:
                    raise AssertionError(f"{form}: launches {line['launches_both_runs']}")
        if "Collect" in envs:
            self.constants_check("collect_1024x1", envs["Collect"])
        hard = envs.get("ObstaclesHard") or envs.get("Collect")
        self.masked_copy_check(f"{hard.scenario.name.lower()}_1024x1", hard)

    # ------------------------------------------------------------- phase 5
    def time_forms(self, env, cases_wanted):
        """Kernel and plain-version milliseconds, bytes, operations and bound
        of the wanted cases at the state `env` ended on ("b2_pvs": B2 with
        the scenario's PVS cluster mask, as the main path renders it)."""
        from megaverse_tpu_torch.env import UNCULLED, RenderMode, render_tables
        RC = self.RC
        height = env.scenario.cfg.obs_height
        base = render_tables(env.scenario, env.state, bucket=env._bucket, mode=UNCULLED)
        cams, prims, ui = base["cams"], base["prims"], base["ui_indicators"]
        cases = {"b1": dict(prims=prims)}
        cases.update(self.form_tables(cams, prims, height, 128))
        if "b2_pvs" in cases_wanted:
            masked = render_tables(env.scenario, env.state, bucket=env._bucket,
                                   mode=RenderMode())
            cases["b2_pvs"] = {k: masked[k] for k in cases["b2"]}
        for form in ("b2", "b3", "b4_tile", "b5"):
            cases["b6_over_" + form] = dict(merge_tiles=True, **cases[form])
        bsz, agents = cams.shape[0], cams.shape[1]
        pixels = bsz * agents * height * 128
        nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts
                                if isinstance(t, torch.Tensor))

        def bound(nb, ops):
            tb, to = 1e3 * nb / HBM_BYTES_PER_S, 1e3 * ops / F32_FLOP_PER_S
            return max(tb, to), ("bytes" if tb >= to else "operations")

        types = prims[:, :, 0]
        n_aabb = int((types == 0).sum().item())
        n_other = int((types > 0).sum().item())
        n_dead = int((types < 0).sum().item())
        out = {}
        for case in cases_wanted:
            tabs = cases[case]
            run = lambda: RC.render_packed(cams, height=height, width=128,
                                           ui_indicators=ui, **tabs)
            ms = time_cuda(run, 20)
            # the plain version takes seconds at this shape: one call, not warmed
            plain_ms = time_cuda(lambda: RC.render_packed_plain(
                cams, height=height, width=128, ui_indicators=ui, **tabs), 1, warm=False)
            # Roofline bound from THIS run's inputs. Bytes: every input read
            # once, the output written once. Operations: the rows each pixel
            # visits: all live rows for B1, for the others what the kernel
            # itself counted per pixel row (`visits`: the clusters whose rows
            # ran for each of the row's 32-pixel segments, summed over them).
            nb = nbytes([cams, *tabs.values()]) + pixels * 4
            if case == "b1":
                ops = (agents * height * 128 * (n_aabb * OPS_ROW_AABB + n_other * OPS_ROW_OTHER
                                                + n_dead * 2) + pixels * OPS_PIXEL_FIXED)
                mean_clusters = None
            else:
                visits = RC.new_visits(cams, height)
                RC.render_packed(cams, height=height, width=128, ui_indicators=ui,
                                 visits=visits, **tabs)
                torch.cuda.synchronize()
                v = visits.sum(dim=(0, 1, 2)).tolist()   # clusters run: [aabb, other]
                ops = (32 * 8 * (v[0] * OPS_ROW_AABB + v[1] * OPS_ROW_OTHER)
                       + pixels * OPS_PIXEL_FIXED)
                mean_clusters = sum(v) / (bsz * agents * height * RC.VISIT_SEGMENTS)
            b_ms, by = bound(nb, ops)
            out[case] = dict(ms=ms, plain_ms=plain_ms, bytes=nb, ops=ops, bound_ms=b_ms,
                             bound_by=by, mean_clusters_run_per_pixel=mean_clusters)
        prologue = {
            "cull_bits": lambda: RC.cull_bits(cams, cases["b2"]["clusters"], height, 128),
            "sort_clusters": lambda: RC.sort_clusters(cams, cases["b3"]["clusters"]),
            "frustum_cull_clusters": lambda: RC.frustum_cull(
                cams, cases["b3"]["clusters"], height, 128),
            "frustum_cull_superclusters": lambda: RC.frustum_cull(
                cams, cases["b5"]["sclusters"], height, 128),
            "all_tables": lambda: self.form_tables(cams, prims, height, 128),
        }
        meta = {"shape": [bsz, agents, height, 128], "rows": int(prims.shape[1]),
                "rows_padded": int(cases["b2"]["prims"].shape[1]),
                "clusters": int(cases["b3"]["clusters"].shape[1]),
                "live_aabb_rows": n_aabb, "live_other_rows": n_other,
                "prologue_ms": {k: time_cuda(f, 5) for k, f in prologue.items()},
                "gpu": self.smi}
        return out, meta

    def time_free_camera(self, env) -> dict:
        """B1's and its plain version's milliseconds and bound for the free
        camera at every size of FREE_CAMERA_SIZES, at the state `env` ended on."""
        RC = self.RC
        out = {}
        for (h, w), tabs in self.free_camera_tables(env).items():
            prims = tabs["prims"]
            types = prims[:, :, 0]
            pixels = h * w
            ops = pixels * (int((types == 0).sum()) * OPS_ROW_AABB
                            + int((types > 0).sum()) * OPS_ROW_OTHER
                            + int((types < 0).sum()) * 2 + OPS_PIXEL_FIXED)
            nb = (tabs["cams"].numel() + prims.numel()) * 4 + pixels * 4
            tb, to = 1e3 * nb / HBM_BYTES_PER_S, 1e3 * ops / F32_FLOP_PER_S
            out[f"{h}x{w}"] = dict(
                ms=time_cuda(lambda t=tabs: RC.render_packed(**t), 20),
                plain_ms=time_cuda(lambda t=tabs: RC.render_packed_plain(**t), 1, warm=False),
                bound_ms=max(tb, to), bound_by="bytes" if tb >= to else "operations",
                rows=int(prims.shape[1]))
        return out

    def kernels_line(self, tower, collect, new_envs, variants) -> None:
        free_camera = self.time_free_camera(collect)
        emit({"phase": "kernel_times", "scenario": "Collect", "free_camera": free_camera,
              "gpu": self.smi})
        all_cases = ("b1", "b2", "b3", "b4_agent", "b4_agent_dist", "b4_tile",
                     "b4_shuffled", "b5", "b6_over_b2", "b6_over_b3", "b6_over_b4_tile",
                     "b6_over_b5")
        at_collect, meta_c = self.time_forms(collect, all_cases)
        at_tower, meta_t = self.time_forms(tower, ("b1", "b2", "b3", "b6_over_b2"))
        emit({"phase": "kernel_times", "scenario": "Collect", **meta_c, "cases": at_collect})
        emit({"phase": "kernel_times", "scenario": "TowerBuilding", **meta_t,
              "cases": at_tower})
        # B2, the main path's form, at the end state of each run of
        # NEW_SCENES and HEX_SCENES; at the hex scenes' with and without the
        # PVS mask
        at_new = {}
        for name, env in new_envs.items():
            wanted = ("b2", "b2_pvs") if name in HEX_SCENES else ("b2",)
            at_new[name], meta = self.time_forms(env, wanted)
            emit({"phase": "kernel_times", "scenario": name, **meta, "cases": at_new[name]})
        # and at the Obstacles variants' end states, timed after their runs
        at_new.update({name: cases for name, (cases, _) in variants.items()})
        # one row per kernel form; B4 is read at the per-tile lists, B6 at the
        # merged bit-walk: the variants the main path ran (B6 over B3 beside it)
        rows = []
        for name, case in (("render_b1", "b1"), ("render_b2", "b2"), ("render_b3", "b3"),
                           ("render_b4", "b4_tile"), ("render_b5", "b5"),
                           ("render_b6", "b6_over_b2")):
            c = at_collect[case]
            row = {"name": name, "route": "cuda", "source": SOURCE,
                   "replaces": REPLACES[name], "launches": self.launches[name],
                   "max_abs_err": self.max_err[name], "ms": c["ms"],
                   "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                   "bound_by": c["bound_by"], "library_ms": None,
                   "shape": "Collect 1024x1",
                   "clusters_run_per_pixel": c["mean_clusters_run_per_pixel"]}
            if case in at_tower:
                t = at_tower[case]
                row.update(ms_towerbuilding=t["ms"], plain_ms_towerbuilding=t["plain_ms"],
                           bound_ms_towerbuilding=t["bound_ms"])
            if name == "render_b1":
                # the free camera: one B1 launch per image, any size
                row["launches_free_camera"] = self.launches_by_part.get("free_camera", 0)
                for size, t in free_camera.items():
                    row.update({f"ms_free_camera_{size}": t["ms"],
                                f"plain_ms_free_camera_{size}": t["plain_ms"],
                                f"bound_ms_free_camera_{size}": t["bound_ms"]})
            if name == "render_b2":
                row["launches_classes"] = self.launches_by_part.get("classes", 0)
                row["launches_parallel_ranks"] = self.launches_by_part.get("parallel_ranks", 0)
                row["launches_bench"] = self.launches_by_part.get("bench", 0)
                # at the hex scenes the main path's B2 runs with the PVS mask
                for scen, cases in at_new.items():
                    key = scen.lower()
                    main = cases.get("b2_pvs", cases["b2"])
                    row.update({f"ms_{key}": main["ms"],
                                f"plain_ms_{key}": main["plain_ms"],
                                f"bound_ms_{key}": main["bound_ms"]})
                    if "b2_pvs" in cases:
                        row.update({f"ms_{key}_without_pvs": cases["b2"]["ms"],
                                    f"bound_ms_{key}_without_pvs": cases["b2"]["bound_ms"]})
            if name == "render_b6":
                for over in ("b3", "b4_tile", "b5"):
                    row.update({f"ms_over_{over}": at_collect[f"b6_over_{over}"]["ms"],
                                f"bound_ms_over_{over}": at_collect[f"b6_over_{over}"]["bound_ms"]})
            rows.append(row)
        # the deferred reset's masked copy (a kernel of the port, not of the
        # TPU), timed on ObstaclesHard's layout leaves in phase 3b
        rows.append({"name": "masked_copy", "route": "cuda", "source": MASKED_COPY_SOURCE,
                     "replaces": MASKED_COPY_REPLACES, "launches": self.mc_launches,
                     "library_ms": None, **self.mc_row})
        # the character controller's kernel (replaces no TPU kernel either),
        # checked and timed at the end states of KCC_RUNS in phase 3b
        kcc = {"name": "kcc", "route": "cuda", "source": KCC_SOURCE, "replaces": KCC_REPLACES,
               "launches": self.kcc_launches, "library_ms": None, "bound_by": "bytes",
               "max_abs_err": max(c["max_abs_err"] for c in self.kcc_cases.values())}
        for label, c in self.kcc_cases.items():
            kcc.update({f"ms_{label}": c["ms"], f"plain_ms_{label}": c["plain_ms"],
                        f"bound_ms_{label}": c["bound_ms"]})
        rows.append(kcc)
        # the object-stacking kernel (replaces no TPU kernel), checked and
        # timed at the end states of STACKING_RUNS in phase 3b
        stack = {"name": "stacking", "route": "cuda", "source": STACKING_SOURCE,
                 "replaces": STACKING_REPLACES, "launches": self.stacking_launches,
                 "library_ms": None, "bound_by": "bytes", "max_abs_err": 0}
        for label, c in self.stacking_cases.items():
            stack.update({f"ms_{label}": c["ms"], f"plain_ms_{label}": c["plain_ms"],
                          f"bound_ms_{label}": c["bound_ms"]})
        rows.append(stack)
        for r in rows:
            if r["launches"] < 1:
                raise AssertionError(f"{r['name']} was never launched on the main path")
        emit({"kernels": rows})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--phase", default="all",
                    choices=["all", "kernels", "train", "parallel", "bench", "obstacles",
                             "capture", "kcc", "stacking"],
                    help="'kernels' stops after the kernel-vs-plain comparison, "
                         "'train' runs only the training paths, 'parallel' only "
                         "the data-parallel checks, 'bench' only the TowerBuilding "
                         "run through the sampling benchmark, 'obstacles' only the "
                         "Obstacles variants' runs, 'capture' the captured-vs-eager "
                         "checks on two envs, 'kcc' the KCC kernel's check on its four "
                         "end states, 'stacking' the stacking kernel's check on its four "
                         "end states (none of them prints the result line)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check only runs on the GPU",
              file=sys.stderr)
        return 2
    # float32 products in full float32 (the learner's card-vs-CPU check)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smoke = Smoke()
    smoke.machine()
    if args.phase == "train":
        smoke.train_update_check()
        smoke.train_path()
        smoke.train_4ag()
        smoke.train_multitask()
        return 0
    if args.phase == "parallel":
        smoke.parallel_world_one()
        smoke.parallel_two_ranks()
        return 0
    if args.phase == "bench":
        smoke.bench_main()
        return 0
    if args.phase == "obstacles":
        smoke.obstacles_variants()
        return 0
    if args.phase == "capture":
        envs = {name: smoke.drive(f"{name.lower()}_1024x1", name, 1024, 1, 64, 2, keep=True)
                for name in ("TowerBuilding", "Collect")}
        smoke.capture_phase(envs)
        return 0
    if args.phase == "kcc":
        smoke.kcc_phase({run[0]: smoke.drive(*run[:6], params=run[6], keep=True)
                         for run in KCC_RUNS})
        return 0
    if args.phase == "stacking":
        smoke.stacking_phase({run[0]: smoke.drive(*run[:6], params=run[6], keep=True)
                              for run in STACKING_RUNS})
        return 0
    smoke.kernels_vs_plain()
    if args.phase == "kernels":
        return 0
    tower, collect, new_envs = smoke.main_path()
    variants = smoke.obstacles_variants()
    smoke.train_update_check()
    smoke.train_path()
    smoke.train_4ag()
    smoke.train_multitask()
    smoke.parallel_world_one()
    smoke.parallel_two_ranks()
    smoke.kernels_line(tower, collect, new_envs, variants)
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    print(smoke.smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
