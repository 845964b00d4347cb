"""The sampler's entry: `VectorEnv.step_many` chunks back to back, each
ending on a read of its checksum, as the upstream sampling benchmark steps N
envs with random actions and renders every agent's frame.

Set-up: the env batch and its first layouts (from the traffic's
`layout_seed`: every run does the same work), an action pool drawn from
`--seed`, warm-up chunks (the tick's eager warm-up and its capture). Window:
chunks until `seconds` have passed. With `trace`, a few chunks inside the
window run under torch.profiler. After the window: the sampled envs' layouts
at reset and after the window's refills, and their sim step, deferred reset
and render over the checked chunks, each against the plain reference. The
sample is a seeded stratified one plus envs whose first episode ends inside
one checked chunk (its end step follows from the layout's episode length),
so that a reset and the refill after it are compared in every run.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

import harness as H
import judge as J
from reference.sim import constants as RC
from reference.sim import env as RE
from reference.sim.scenarios import make_scenario as make_reference_scenario


def program_env(traffic: dict, seed: int, device, rank: int, world: int):
    from megaverse_tpu_torch.vector_env import VectorEnv

    return VectorEnv(traffic["scenario"], traffic["num_envs"] * world,
                     num_agents_per_env=traffic["num_agents_per_env"], seed=seed,
                     device=device, obs_format="packed",
                     shard=(rank, world) if world > 1 else None)


def run(cell, seed: int, seconds: float, trace: bool, device, rank: int = 0, world: int = 1,
        t_start: float = None, make_env=program_env, control: bool = False) -> Dict:
    """One run of a sampler cell on `device`. `make_env` builds the program's
    env (a test may hand in a broken one). `control`: judge the
    lower-precision control (the reference with its float state, layouts and
    camera table in bfloat16) in the program's place."""
    t_start = time.perf_counter() if t_start is None else t_start
    if "host_threads" in cell.config:
        torch.set_num_threads(cell.config["host_threads"])
    tr = cell.traffic
    B, A = tr["num_envs"], tr["num_agents_per_env"]
    steps, n_pool = tr["chunk_steps"], tr["action_pool"]
    env = make_env(tr, tr["layout_seed"], device, rank, world)
    pool = J.action_pool(seed, B * world, A, n_pool, RC.ACTION_SPACE_SIZES,
                         RC.ACTION_HEAD_BITS)[:, rank * B:(rank + 1) * B]
    env.reset()
    # the envs whose first episode ends inside one chunk of the window: that
    # chunk is checked, with some of them
    ends = J.first_done_steps(env.state.episode_len_sec.cpu().numpy(),
                              make_reference_scenario(tr["scenario"], num_agents=A).cfg.dt)
    done_chunk, enders = J.pick_ending(
        seed, J.ending_stretches(ends, tr["warmup_chunks"] * steps, steps,
                                 tr["check_done_within_chunks"]), tr["check_done_envs"])
    strata = J.stratified(seed, B, tr["check_envs"])
    sample = sorted(set(strata) | set(enders))
    idx = torch.tensor(sample, dtype=torch.long, device=device)
    roof_idx = torch.tensor(strata, dtype=torch.long, device=device)
    reset_state = J.to_host(J.gather(env.state, idx))
    reset_next = J.to_host(J.gather(env.next_scenes, idx))
    done_count = torch.zeros((B,), dtype=torch.int64, device=device)

    def chunk():
        obs, dones, csums = env.step_many(pool, steps)
        done_count.add_(torch.stack(dones).sum(dim=0))
        return obs, dones, csums

    for _ in range(tr["warmup_chunks"]):
        _, _, csums = chunk()
        int(csums[-1])
    env.flush()
    # reset queued every env's next layout on the prefetch threads: a fresh
    # env's one-time backlog, left to finish in set-up, not in the window
    for q in getattr(env, "_prefetch_q", None) or ():
        for fut in q:
            fut.result()
    H.sync(device)
    captures0, layout0, refills0 = env.captures, env.layout_seconds, env.num_refills
    if world > 1:
        torch.distributed.barrier()
    setup_s = time.perf_counter() - t_start

    checked = set(J.picks(seed, 0, tr["check_within_chunks"], tr["check_chunks"]))
    if done_chunk is not None:
        checked.add(done_chunk)
    profile_from, profile_n = tr["profile_from_chunk"], tr["profile_chunks"]
    prof = prof_done = None
    roof = None
    profiled: List[int] = []
    snaps: List[Dict] = []
    chunk_s: List[float] = []
    t0 = time.perf_counter()
    n = 0
    while True:
        if trace and n == profile_from:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
        pre = None
        if n in checked:
            pre = (J.gather(env.state, idx), J.gather(env.next_scenes, idx))
        # the first profiled chunk is not read: the tracer starts up in it
        labelled = prof is not None and n > profile_from
        if prof is not None:
            profiled.append(n)
        tc = time.perf_counter()
        if labelled:
            with torch.profiler.record_function("bench.chunk"):
                obs, dones, csums = chunk()
            with torch.profiler.record_function("bench.read"):
                int(csums[-1])
        else:
            obs, dones, csums = chunk()
            int(csums[-1])
        now = time.perf_counter()
        chunk_s.append(now - tc)
        if pre is not None:
            snaps.append(dict(chunk=n, pre_state=pre[0], pre_next=pre[1],
                              post_state=J.gather(env.state, idx),
                              dones=torch.stack(dones).index_select(1, idx),
                              frame=obs.index_select(0, idx)))
        n += 1
        if prof is not None and (n == profile_from + 1 + profile_n or now - t0 >= seconds):
            H.sync(device)
            prof.__exit__(None, None, None)
            prof_done = prof
            prof = None
            # the scene of the last traced tick, for the render's roofline
            roof = (J.gather(env.state, roof_idx), _live_rows(env.state))
        if now - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    layout_s = env.layout_seconds - layout0
    refills = env.num_refills - refills0
    captures = env.captures - captures0
    if world > 1:
        torch.distributed.barrier()

    # the window has closed: the program's peak, then its state is freed
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    env.flush()
    end_next = J.to_host(J.gather(env.next_scenes, idx))
    counts = done_count.index_select(0, idx).cpu().tolist()
    scene = None
    if roof is not None:
        scene = dict(state=J.to_host(roof[0]), live_rows=int(roof[1]), num_envs=B)
    snaps = [{k: (J.to_host(v) if isinstance(v, dict) else
                  v.cpu() if torch.is_tensor(v) else v) for k, v in s.items()} for s in snaps]
    env.close()
    del env
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks = judge(cell, seed, device, sample, pool, reset_state, reset_next, end_next, counts,
                   snaps, rank, world, control)
    if world > 1:
        checks = _worst_over_ranks(checks, device)

    obs_done = B * world * A * steps * n
    result = dict(
        end_to_end={"obs_per_sec": obs_done / window_s, "setup_s": setup_s},
        attempted=n, failed=0, checks=checks,
        device=dict(H.device_line(device, world), memory_peak_bytes=peak),
        counters=dict(chunks=n, steps=n * steps, window_s=window_s, layout_seconds=layout_s,
                      refills=refills, captures=captures, chunk_ms=[1e3 * c for c in chunk_s],
                      profiled_chunks=profiled),
        notes={"chunks": f"{n} chunks of {steps} steps in {window_s:.3f} s; "
                         f"{refills} refills, {captures} captures in the window; "
                         f"chunk ms median {1e3 * float(np.median(chunk_s)):.3f}; slowest "
                         f"(chunk, ms) {_slowest(chunk_s)}"},
        scene=scene, config=cell.config, traffic=tr)
    marks = (H.profiled_window(prof_done, "bench.chunk", "bench.read")
             if prof_done is not None else None)
    if marks is not None:
        summary = H.TraceSummary.from_profiler(prof_done, ["bench.chunk", "bench.read"], marks)
        result["trace"] = summary
        result["trace_steps"] = profile_n * steps
        result["trace_chunks"] = profile_n
        result["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = {"device_ops": summary.top_ops(), "idle_gaps": summary.gaps()}
    return result


def _slowest(chunk_s, k: int = 6):
    order = sorted(range(len(chunk_s)), key=lambda i: -chunk_s[i])[:k]
    return [(i, round(1e3 * chunk_s[i], 1)) for i in sorted(order)]


def _live_rows(state) -> torch.Tensor:
    """Live primitive rows of the whole batch as the scene describes them
    (boxes with a colour, props that are visible), as a device scalar."""
    from reference.sim.types import PROP_FLAG_VISIBLE

    boxes = (state.box_color > 0).sum()
    props = (((state.props.flags & PROP_FLAG_VISIBLE) != 0)
             & (state.props.type != RC.PROP_NONE)).sum()
    return boxes + props


def _worst_over_ranks(checks, device):
    import torch.distributed as dist

    vals = torch.tensor([v for v, _ in checks.values()], dtype=torch.float64, device=device)
    dist.all_reduce(vals, op=dist.ReduceOp.MAX)
    return {k: (float(v), lim) for (k, (_, lim)), v in zip(checks.items(), vals.tolist())}


# ----------------------------------------------------------------- judge
def reference_chunk(scenario, state, next_scenes, actions, control: bool = False):
    """The reference's chunk: env_step per action row on a copy of `state`
    (a reference EnvState), then the last state rendered. Returns (final
    state, done flags [steps, S], frame [S, A, H, W]). `control`: every
    float leaf rounded to bfloat16 after each step, the camera table too."""
    from reference.sim.types import tree_map

    state = tree_map(lambda x: x.clone(), state)
    shaping = torch.from_numpy(np.tile(scenario.shaping_array()[None],
                                       (state.done.shape[0], 1, 1))).to(state.done.device)
    dones = []
    for a in actions:
        res = RE.env_step(scenario, state, next_scenes, a, shaping)
        state = tree_map(J.lower, res.state) if control else res.state
        dones.append(res.done)
    frame = RE.render(scenario, state, ray_dtype=torch.bfloat16 if control else None)
    return state, torch.stack(dones), frame


def judge(cell, seed, device, sample, pool, reset_state, reset_next, end_next, counts, snaps,
          rank, world, control=False) -> Dict:
    """The compared numbers of a sampler run with their limits; with
    `control`, the control's layouts, states and frames stand in the
    program's place."""
    tr = cell.traffic
    B, A = tr["num_envs"], tr["num_agents_per_env"]
    scenario = make_reference_scenario(tr["scenario"], num_agents=A)
    glob = [rank * B + i for i in sample]
    lay = J.ReferenceLayouts(scenario, tr["layout_seed"], B * world, glob)
    # layouts: the first two of every sampled env at reset, then the one each
    # holds in its buffer after the window's refills
    rng = torch.tensor(glob, dtype=torch.int64) + (int(tr["layout_seed"]) << 20)
    first = lay.stacked(glob, [0] * len(glob))
    from reference.sim.types import scene_to_device, state_from_scene

    template_scene = lay.layout(glob[0], 0)
    first_t = scene_to_device(J.rebuild(template_scene, first), "cpu")
    ref_reset = J.leaves(state_from_scene(first_t, A, rng))
    ref_next = lay.stacked(glob, [1] * len(glob))
    ref_end = lay.stacked(glob, [c + 1 for c in counts])
    if control:
        low = lambda d: {k: J.lower(torch.as_tensor(np.asarray(v))) for k, v in d.items()}
        reset_state, reset_next, end_next = low(ref_reset), low(ref_next), low(ref_end)
    mism = (J.mismatches(reset_state, ref_reset) + J.mismatches(reset_next, ref_next)
            + J.mismatches(end_next, ref_end))

    state_gap, frame_off, resets = 0.0, 0.0, 0
    template_state = state_from_scene(first_t, A, rng)
    for s in snaps:
        st = J.rebuild(template_state, {k: v.to(device) for k, v in s["pre_state"].items()})
        nx = J.rebuild(template_scene,
                       {k: v.to(device) for k, v in s["pre_next"].items()})
        acts = [torch.from_numpy(pool[i % pool.shape[0]][sample]).to(device)
                for i in range(tr["chunk_steps"])]
        with torch.no_grad():
            fin, dones, frame = reference_chunk(scenario, st, nx, acts)
            if control:
                c_fin, c_dones, c_frame = reference_chunk(scenario, st, nx, acts, control=True)
                s = dict(s, post_state=J.to_host(J.leaves(c_fin)), dones=c_dones.cpu(),
                         frame=c_frame.cpu())
        got = dict(s["post_state"])
        got["_dones"] = s["dones"]
        want = {k: v.cpu() for k, v in J.leaves(fin).items()}
        want["_dones"] = dones.cpu()
        resets += int(dones.sum())
        state_gap = max(state_gap, J.tree_gap(got, want))
        frame_off = max(frame_off, J.frame_px_off(s["frame"], frame.cpu()))
    if not snaps:
        state_gap = frame_off = float("inf")   # no chunk checked: nothing proven
    L = J.LIMITS
    return {"layout_mismatch": (float(mism), L["layout_mismatch"]),
            "state_gap": (state_gap, L["state_gap"]),
            "frame_px_off": (frame_off, L["frame_px_off"]),
            "resets_unchecked": (float(resets == 0), L["resets_unchecked"])}
