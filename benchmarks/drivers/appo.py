"""The training entry: the port's synchronous APPO iteration as
`megaverse_tpu_torch.rl.train` runs it: `collect_rollout` (the policy's
forward and sampling, the captured env tick), the PPO update
(`_update_from_batch`; data-parallel over the ranks through
`ParallelLearner` on several cards), then the task's layout refill.

Set-up: the task as `rl.train` makes it (`_make_tasks`: the first layouts in
worker processes, from the traffic's `layout_seed`), the parameters and the
action sampler's generator made by the benchmark from `--seed` and handed
to the learner, then the first `warmup_iterations` iterations through
the same calls (the tick's warm-up and capture happen there); those are the
iterations the reference follows. Window: iterations until `seconds` have
passed, the ranks agreeing when to stop; it ends on a device synchronise
after the last update. With `trace`, one iteration inside the window runs
under torch.profiler. One iteration of the window, in which some envs'
first episodes end (their end steps follow from the layouts' episode
lengths), is checked too: its rollout of the sampled envs and those enders
(the deferred reset and the refill after it), its policy outputs (the
carry zeroed at a done) and its update (returns cut at a done), each from
the program's own parameters and optimizer moment before it.
"""

from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

import harness as H
import judge as J
from reference import policy as RP
from reference.sim import env as RE
from reference.sim.scenarios import make_scenario as make_reference_scenario
from reference.sim.types import multidiscrete_to_bitmask, scene_to_device, state_from_scene
from reference.sim.types import tree_map as ref_tree_map

BATCH_FIELDS = ("obs", "actions", "logp", "value", "reward", "done", "init_carry")


def train_config(cfg: Dict):
    from megaverse_tpu_torch.rl.learner import TrainConfig

    return TrainConfig(rollout=cfg["rollout"], lr=cfg["learning_rate"], gamma=cfg["gamma"],
                       gae_lambda=cfg["gae_lambda"], clip_ratio=cfg["ppo_clip_ratio"],
                       value_coeff=cfg["value_loss_coeff"],
                       exploration_coeff=cfg["exploration_loss_coeff"],
                       max_grad_norm=cfg["max_grad_norm"], reward_clip=cfg["reward_clip"],
                       num_epochs=cfg["ppo_epochs"], num_minibatches=cfg["num_minibatches"],
                       hidden_size=cfg["hidden_size"], use_rnn=True,
                       rnn_num_layers=cfg["rnn_num_layers"], model_dtype=torch.bfloat16)


def program_task(cfg: Dict, traffic: Dict, seed: int, device, rank: int, world: int):
    """The program's task (env batch, learner, runner) as rl.train makes it."""
    from megaverse_tpu_torch.rl import train as T

    args = SimpleNamespace(num_envs=traffic["num_envs"] * world,
                           num_agents_per_env=traffic["num_agents_per_env"], seed=seed)
    workers = traffic["layout_workers"]
    tasks, _ = T._make_tasks([traffic["scenario"]], args, train_config(cfg), device, rank,
                             world, workers=workers if workers > 1 else 0)
    return tasks[0]


class Timer:
    """Device-clock spans on CUDA (events), host-clock spans on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.spans: List = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def add(self, a, b):
        self.spans.append((a, b))

    def ms(self) -> List[float]:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in self.spans]
        return [1e3 * (b - a) for a, b in self.spans]


def run(cell, seed: int, seconds: float, trace: bool, device, rank: int = 0, world: int = 1,
        t_start: float = None, make_task=program_task, control: bool = False) -> Dict:
    """One run of an APPO cell on `device` (this rank's share). `make_task`
    builds the program's task (a test may hand in a broken one). `control`:
    judge the lower-precision control in the program's place: the reference
    with its float32 matrix products in TF32, its sim's float state, layouts
    and camera table in bfloat16."""
    t_start = time.perf_counter() if t_start is None else t_start
    cfg, tr = cell.config, cell.traffic
    B, A, T = tr["num_envs"], tr["num_agents_per_env"], cfg["rollout"]
    task = make_task(cfg, tr, tr["layout_seed"], device, rank, world)
    params0 = RP.make_params(cfg, seed, device)
    have = {k: tuple(v.shape) for k, v in task.ls.params.items()}
    if have != RP.param_shapes(cfg):
        raise RuntimeError(f"the program's parameters differ from the configuration's: {have}")
    # the parameters and the action sampler's generator come from the seed
    # (the layouts from the traffic's `layout_seed`: every run does the same
    # work)
    gen = torch.Generator(device=device).manual_seed(
        int(np.random.SeedSequence([seed, 23, rank]).generate_state(1)[0]))
    task.ls = task.ls._replace(params={k: v.clone() for k, v in params0.items()}, rng=gen)
    # one iteration of the window in which some envs' first episodes end,
    # the same on every rank; it is checked, with some of those envs
    ends = J.first_done_steps(task.ls.env_state.episode_len_sec.cpu().numpy(),
                              make_reference_scenario(tr["scenario"], num_agents=A).cfg.dt)
    within = tr["check_done_within_iterations"]
    enders = J.ending_stretches(ends, tr["warmup_iterations"] * T, T, within)
    done_it, done_envs = J.pick_ending(seed, enders, tr["check_done_envs"],
                                       _common(enders, within, device, world))
    sample = sorted(set(J.stratified(seed, B, tr["check_envs"])) | set(done_envs))
    idx = torch.tensor(sample, dtype=torch.long, device=device)
    start_state = J.to_host(J.gather(task.ls.env_state, idx))
    start_next = J.to_host(J.gather(task.next_scenes, idx))
    done_sums: List[torch.Tensor] = []
    rollout_t, update_t = Timer(device), Timer(device)

    def iteration(timed: bool):
        ls = task.ls
        a = rollout_t.mark() if timed else None
        ls, batch = task.runner.collect_rollout(ls, task.next_scenes, task.shaping)
        b = rollout_t.mark() if timed else None
        ls, metrics = task.runner._update_from_batch(ls, batch)
        c = update_t.mark() if timed else None
        if timed:
            rollout_t.add(a, b)
            update_t.add(b, c)
        task.ls = ls
        done_sums.append(batch.done.sum(dim=0))
        task.refill()
        return ls, batch, metrics

    def checked_iteration():
        ls = task.ls
        rec = {"pre_state": J.gather(ls.env_state, idx),
               "pre_next": J.gather(task.next_scenes, idx),
               "params": {k: v.clone() for k, v in ls.params.items()},
               "mu": {k: v.clone() for k, v in ls.opt_state["mu"].items()}}
        ls, batch, metrics = iteration(False)
        rec.update(batch={f: getattr(batch, f).clone() for f in BATCH_FIELDS},
                   last_obs=ls.obs.clone(), loss=torch.as_tensor(metrics["loss"]).clone(),
                   post_state=J.gather(ls.env_state, idx),
                   mu_after={k: v.clone() for k, v in ls.opt_state["mu"].items()})
        return rec

    # the first iterations, through the window's own calls: the reference
    # follows them
    followed = []
    for k in range(tr["warmup_iterations"]):
        ls, batch, metrics = iteration(False)
        rec = {"batch": {f: getattr(batch, f).cpu() for f in BATCH_FIELDS},
               "last_obs": ls.obs.cpu(), "loss": float(metrics["loss"])}
        if k == 0:
            rec["post_state"] = J.to_host(J.gather(ls.env_state, idx))
            rec["mu"] = {n: v.cpu() for n, v in ls.opt_state["mu"].items()}
        followed.append(rec)
    params3 = {n: v.cpu() for n, v in task.ls.params.items()}
    H.sync(device)
    if world > 1:
        torch.distributed.barrier()
    setup_s = time.perf_counter() - t_start

    def stop(elapsed: float) -> bool:
        flag = torch.tensor([1.0 if elapsed >= seconds else 0.0], device=device)
        if world > 1:
            torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MAX)
        return bool(flag.item())

    prof_done = checked = None
    profile_at = tr["profile_from_iteration"]
    profiled_s, profiled_n = 0.0, 0
    t0 = time.perf_counter()
    n = 0
    while True:
        if trace and prof_done is None and n >= profile_at and done_it not in (n, n + 1):
            # two iterations under the profiler, the first not read (the
            # tracer starts up in it); both left out of the timed spans
            from torch.profiler import ProfilerActivity, profile
            tp = time.perf_counter()
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
            iteration(False)
            with torch.profiler.record_function("bench.iteration"):
                iteration(False)
            H.sync(device)
            prof.__exit__(None, None, None)
            prof_done = prof
            profiled_s += time.perf_counter() - tp
            profiled_n += 2
            n += 2
        elif n == done_it:
            checked = checked_iteration()
            n += 1
        else:
            iteration(True)
            n += 1
        if stop(time.perf_counter() - t0):
            break
    H.sync(device)
    window_s = time.perf_counter() - t0
    if world > 1:
        torch.distributed.barrier()

    # the window has closed: the program's peak, then its state is freed
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    counts = (torch.stack(done_sums[:-1]).sum(dim=0).index_select(0, idx).cpu().tolist()
              if len(done_sums) > 1 else [0] * len(sample))
    end_next = J.to_host(J.gather(task.next_scenes, idx))
    rollout_ms, update_ms = rollout_t.ms(), update_t.ms()
    if checked is not None:
        checked = {k: (J.to_host(v) if isinstance(v, dict) else v.cpu())
                   for k, v in checked.items()}
    task.close()
    del task
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks = judge(cell, seed, device, sample, params0, followed, params3, start_state,
                   start_next, end_next, counts, rank, world, control, checked)

    samples = n * B * world * A * T
    result = dict(
        end_to_end={"train_samples_per_sec": samples / window_s, "setup_s": setup_s},
        attempted=n, failed=0, checks=checks,
        device=dict(H.device_line(device, world), memory_peak_bytes=int(_max_over_ranks(
            float(peak), device, world))),
        # the iterations that ran without the profiler, for rates read in a
        # traced run
        counters=dict(iterations=n, samples=samples, window_s=window_s, chips=world,
                      unprofiled_samples=(n - profiled_n) * B * world * A * T,
                      unprofiled_window_s=window_s - profiled_s),
        rollout_ms=rollout_ms, update_ms=update_ms,
        notes={"iterations": f"{n} iterations of {B * world} envs x {A} agents x {T} steps "
                             f"in {window_s:.3f} s; rollout ms median "
                             f"{float(np.median(rollout_ms)):.3f}, update ms median "
                             f"{float(np.median(update_ms)):.3f}"},
        config=cfg, traffic=tr)
    marks = (H.profiled_window(prof_done, "bench.iteration", "bench.iteration")
             if prof_done is not None else None)
    if marks is not None:
        summary = H.TraceSummary.from_profiler(prof_done, ["bench.iteration"], marks)
        result["trace"] = summary
        result["trace_iterations"] = 1
        busy = _mean_over_ranks([summary.busy_s, summary.window_s], device, world)
        result["device"].update(busy_s=busy[0], window_s=busy[1])
        result["breakdown"] = {"device_ops": summary.top_ops(), "idle_gaps": summary.gaps()}
    return result


def _common(enders, within: int, device, world: int):
    """The stretches in which envs of every rank end (None on one rank)."""
    if world == 1:
        return None
    mask = torch.zeros((within,), dtype=torch.float32, device=device)
    if enders:
        mask[list(enders)] = 1.0
    torch.distributed.all_reduce(mask, op=torch.distributed.ReduceOp.MIN)
    return torch.nonzero(mask).flatten().tolist()


def _max_over_ranks(x: float, device, world: int) -> float:
    if world == 1:
        return x
    t = torch.tensor([x], dtype=torch.float64, device=device)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
    return float(t.item())


def _mean_over_ranks(xs: List[float], device, world: int) -> List[float]:
    if world == 1:
        return xs
    t = torch.tensor(xs, dtype=torch.float64, device=device)
    torch.distributed.all_reduce(t)
    return (t / world).tolist()


# ----------------------------------------------------------------- judge
def reference_rollout(scenario, state, next_scenes, actions, shaping, reward_clip, frames_at,
                      control: bool = False):
    """The reference env over a rollout's actions [T, S, A, 6] from `state`
    (reference trees on one device): (rewards [T, S, A] clipped, dones
    [T, S], the final state, {t: frame after step t} for t in frames_at,
    -1 for the state before the first step). `control`: every float leaf
    rounded to bfloat16 after each step, the camera table too."""
    state = ref_tree_map(lambda x: x.clone(), state)
    ray = torch.bfloat16 if control else None
    frames = {}
    if -1 in frames_at:
        frames[-1] = RE.render(scenario, state, ray_dtype=ray)
    rewards, dones = [], []
    for t in range(actions.shape[0]):
        res = RE.env_step(scenario, state, next_scenes, multidiscrete_to_bitmask(actions[t]),
                          shaping)
        state = ref_tree_map(J.lower, res.state) if control else res.state
        rewards.append(torch.clamp(res.reward, -reward_clip, reward_clip))
        dones.append(res.done)
        if t in frames_at:
            frames[t] = RE.render(scenario, state, ray_dtype=ray)
    return torch.stack(rewards), torch.stack(dones), state, frames


def _allreduce_mean(grads: Dict[str, torch.Tensor], world: int) -> Dict[str, torch.Tensor]:
    if world == 1:
        return grads
    out = {}
    for k, g in grads.items():
        g = g.clone()
        torch.distributed.all_reduce(g)
        out[k] = g / world
    return out


def update_step(cfg, params, rec, device, world: int, tf32: bool = False):
    """The reference's PPO step at `params` on one rank's rollout `rec`,
    all-reduced over the ranks: (loss, clipped gradient, the leaves that
    move: those whose gradient is at least a thousandth of the median
    leaf's)."""
    bt = {f: v.to(device) for f, v in rec["batch"].items()}
    loss, grads = RP.loss_and_grads(params, cfg, bt, rec["last_obs"].to(device), tf32)
    del bt
    loss = float(_allreduce_mean({"l": loss.reshape(1)}, world)["l"][0])
    grads = _allreduce_mean(grads, world)
    moved = J.moved_leaves(grads)
    with torch.no_grad():
        grads = RP.clip_global_norm(grads, cfg["max_grad_norm"])
    return loss, grads, moved


def follow(cfg, params0, followed, device, world: int, tf32: bool = False) -> Dict:
    """The reference's first updates from `params0` on the program's
    rollouts: each step's loss, the first clipped gradient, the leaves that
    move, the parameters after the last."""
    p, opt = dict(params0), RP.adam_init(params0)
    out = {"losses": []}
    for k, rec in enumerate(followed):
        loss, grads, moved = update_step(cfg, p, rec, device, world, tf32)
        out["losses"].append(loss)
        if k == 0:
            out["moved"] = moved
            out["g1"] = {n: v.cpu() for n, v in grads.items()}
        with torch.no_grad():
            p, opt = RP.adam(p, grads, opt, cfg)
    out["params3"] = {n: v.cpu() for n, v in p.items()}
    return out


def judge(cell, seed, device, sample, params0, followed, params3, start_state, start_next,
          end_next, counts, rank, world, control=False, checked=None) -> Dict:
    """The compared numbers of an APPO run with their limits; with
    `control`, the control's layouts, sim, policy outputs and updates stand
    in the program's place. `checked`: the window's checked iteration (None
    where the window closed before it)."""
    cfg, tr = cell.config, cell.traffic
    B, A, T = tr["num_envs"], tr["num_agents_per_env"], cfg["rollout"]
    L = J.LIMITS
    scenario = make_reference_scenario(tr["scenario"], num_agents=A)
    glob = [rank * B + i for i in sample]
    lay = J.ReferenceLayouts(scenario, tr["layout_seed"], B * world, glob)
    # layouts at the start and after the window's refills
    template_scene = lay.layout(glob[0], 0)
    first = scene_to_device(J.rebuild(template_scene, lay.stacked(glob, [0] * len(glob))), "cpu")
    rng = torch.tensor(glob, dtype=torch.int64) + (int(tr["layout_seed"]) << 20)
    template_state = state_from_scene(first, A, rng)
    ref_start = J.leaves(template_state)
    ref_next = lay.stacked(glob, [1] * len(glob))
    ref_end = lay.stacked(glob, [c + 1 for c in counts])
    got_start, got_next, got_end = start_state, start_next, end_next
    if control:
        low = lambda d: {k: J.lower(torch.as_tensor(np.asarray(v))) for k, v in d.items()}
        got_start, got_next, got_end = low(ref_start), low(ref_next), low(ref_end)
    mism = (J.mismatches(got_start, ref_start) + J.mismatches(got_next, ref_next)
            + J.mismatches(got_end, ref_end))

    shaping = torch.from_numpy(np.tile(scenario.shaping_array()[None],
                                       (len(sample), 1, 1))).to(device)
    frames_at = set(J.picks(seed, 0, T, tr["check_frames"])) | {-1, T - 1}
    sidx = torch.tensor(sample, dtype=torch.long)

    def rollout_gaps(rec, pre_state, pre_next):
        """(state gap, frame share off, reference dones) of the sampled envs
        over a rollout: the sim, deferred reset and render, with the actions
        the policy sampled."""
        b = rec["batch"]
        st = J.rebuild(template_state, {k: v.to(device) for k, v in pre_state.items()})
        nx = J.rebuild(template_scene, {k: v.to(device) for k, v in pre_next.items()})
        acts = b["actions"].index_select(1, sidx).to(device)
        with torch.no_grad():
            rew, dones, fin, frames = reference_rollout(scenario, st, nx, acts, shaping,
                                                        cfg["reward_clip"], frames_at)
        got = dict(rec["post_state"])
        got["_reward"] = b["reward"].index_select(1, sidx)
        got["_done"] = b["done"].index_select(1, sidx)
        got_frames = {t: (b["obs"][t + 1] if t + 1 < T else rec["last_obs"]).index_select(0, sidx)
                      for t in frames}
        if control:
            with torch.no_grad():
                c_rew, c_dones, c_fin, c_frames = reference_rollout(
                    scenario, st, nx, acts, shaping, cfg["reward_clip"], frames_at, control=True)
            got = J.to_host(J.leaves(c_fin))
            got["_reward"], got["_done"] = c_rew.cpu(), c_dones.cpu()
            got_frames = {t: f.cpu() for t, f in c_frames.items()}
        want = {k: v.cpu() for k, v in J.leaves(fin).items()}
        want["_reward"], want["_done"] = rew.cpu(), dones.cpu()
        return (J.tree_gap(got, want),
                max(J.frame_px_off(got_frames[t], fr.cpu()) for t, fr in frames.items()),
                int(dones.sum()))

    def policy_gap_of(rec, params):
        """The rollout's stored log-probabilities and values against the
        reference policy's at the same parameters, relative to the
        reference's largest."""
        with torch.no_grad():
            bt = {k: v.to(device) for k, v in rec["batch"].items()}
            logp, value = RP.policy_outputs(params, cfg, bt)
            if control:
                bt["logp"], bt["value"] = RP.policy_outputs(params, cfg, bt, tf32=True)
            scale = max(float(logp.abs().max()), float(value.abs().max()), 1e-6)
            return max(float((logp - bt["logp"]).abs().max()),
                       float((value - bt["value"]).abs().max())) / scale

    # the first rollout, from the start, and the policy's forward over it
    one = followed[0]
    state_gap, frame_off, _ = rollout_gaps(one, start_state, start_next)
    policy_gap = policy_gap_of(one, params0)

    # the update: the reference follows the first iterations from the same
    # parameters on the program's rollouts
    ref = follow(cfg, params0, followed, device, world)
    if control:
        ctl = follow(cfg, params0, followed, device, world, tf32=True)
        losses = ctl["losses"]
        prog_g1, params3 = ctl["g1"], ctl["params3"]
    else:
        losses = [rec["loss"] for rec in followed]
        b1c = cfg["adam"]["b1"]
        prog_g1 = {n: v / (1.0 - b1c) for n, v in followed[0]["mu"].items()}
    loss_gap = max(abs(a - b) / max(abs(b), 1e-3) for a, b in zip(losses, ref["losses"]))
    grad_gap = J.leaf_norm_gap(prog_g1, ref["g1"], ref["moved"])
    p0 = {n: v.cpu() for n, v in params0.items()}
    change_prog = {n: params3[n] - p0[n] for n in p0}
    change_ref = {n: ref["params3"][n] - p0[n] for n in p0}
    change3_gap = J.leaf_norm_gap(change_prog, change_ref, ref["moved"])
    checks = {"layout_mismatch": (float(mism), L["layout_mismatch"]),
              "state_gap": (state_gap, L["state_gap"]),
              "frame_px_off": (frame_off, L["frame_px_off"]),
              "policy_gap": (policy_gap, L["policy_gap"]),
              "loss_gap": (loss_gap, L["loss_gap"]),
              "grad_gap": (grad_gap, L["grad_gap"]),
              "change3_gap": (change3_gap, L["change3_gap"])}

    # the window's checked iteration, in which sampled envs end episodes:
    # its rollout, policy outputs and update, from the program's parameters
    # and Adam moment before it
    resets = 0
    if checked is not None:
        pj = {n: v.to(device) for n, v in checked["params"].items()}
        s_gap, f_off, resets = rollout_gaps(checked, checked["pre_state"], checked["pre_next"])
        p_gap = policy_gap_of(checked, pj)
        r_loss, r_grad, moved = update_step(cfg, pj, checked, device, world)
        if control:
            loss_j, g_j, _ = update_step(cfg, pj, checked, device, world, tf32=True)
        else:
            loss_j = float(checked["loss"])
            b1c = cfg["adam"]["b1"]
            g_j = {n: (checked["mu_after"][n].double() - b1c * checked["mu"][n].double())
                   / (1.0 - b1c) for n in checked["mu"]}
        del pj
        for name, value in (("state_gap", s_gap), ("frame_px_off", f_off),
                            ("policy_gap", p_gap),
                            ("loss_gap", abs(loss_j - r_loss) / max(abs(r_loss), 1e-3)),
                            ("grad_gap", J.leaf_norm_gap(g_j, r_grad, moved))):
            checks[name] = (max(checks[name][0], value), checks[name][1])
    checks["resets_unchecked"] = (float(resets == 0), L["resets_unchecked"])
    if world > 1:
        # every rank's parameters after the updates equal rank 0's
        gap = 0.0
        for n, v in params3.items():
            mine = v.to(device)
            lead = mine.clone()
            torch.distributed.broadcast(lead, src=0)
            gap = max(gap, float((mine - lead).abs().max()))
        checks["rank_param_gap"] = (gap, L["rank_param_gap"])
        vals = torch.tensor([v for v, _ in checks.values()], dtype=torch.float64, device=device)
        torch.distributed.all_reduce(vals, op=torch.distributed.ReduceOp.MAX)
        checks = {k: (float(v), lim) for (k, (_, lim)), v in zip(checks.items(), vals.tolist())}
    return checks
