"""APPO-style learner on the device (counterpart of megaverse_tpu/rl/learner.py).

The reference delegates training to Sample Factory APPO across processes
(megaverse_rl/train_megaverse.py:32-42: actor workers render on GPUs, a learner
process optimizes). Here one process drives both on one card: the rollout is
a host loop of batched steps (policy inference and sampling, eager; then the
env tick, `capture.tick`: `env_step`, the reference's deferred auto-reset
where it takes one, one render kernel launch, replayed from a CUDA graph on a
CUDA device) whose observations never leave the device, written into rollout
buffers, then one PPO update on the trajectory. Nothing in a rollout or an
update reads a device value on the host.

Hyperparameter defaults follow the reference README training command
(README.md:134: rollout 32, recurrence 32, batch 4096) and
megaverse_params.py:4-21 (symmetric_kl exploration loss, coeff 0.001).

The update is written to the JAX package's formulas (optax's), not to torch
lookalikes:
- advantages are normalised by the population standard deviation (jnp.std);
- the global-norm clip scales by max_norm / norm only when norm >= max_norm
  (optax.clip_by_global_norm; clip_grad_norm_ adds 1e-6 to the norm);
- Adam is written out (`adam_update`): b1 0.9, b2 0.999, eps 1e-8 outside the
  square root, bias-corrected (optax.adam);
- the linear learning-rate schedule is read at the update count before it
  increments (optax.linear_schedule).

Parameters are a dict of tensors (the model's state_dict) passed through the
functions, as the JAX learner passes its parameter tree; the model module only
supplies the computation (`torch.func.functional_call`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from megaverse_tpu_torch.capture import TickGraphs
from megaverse_tpu_torch.env import RenderMode
from megaverse_tpu_torch.models.actor_critic import (
    ActorCritic,
    action_log_prob_entropy,
    sample_actions,
    symmetric_kl_from_uniform,
)
from megaverse_tpu_torch.scenarios.base import Scenario
from megaverse_tpu_torch.types import EnvState, SceneData, multidiscrete_to_bitmask
from megaverse_tpu_torch.utils.logging import span

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    rollout: int = 32
    lr: float = 1e-4
    gamma: float = 0.997
    gae_lambda: float = 0.95
    clip_ratio: float = 0.1
    value_coeff: float = 0.5
    exploration_coeff: float = 0.001  # symmetric_kl, megaverse_params.py:17
    max_grad_norm: float = 4.0  # 0 disables clipping (reference runs pass 0)
    reward_clip: float = 30.0   # clamp |reward| before the update (SF --reward_clip)
    num_epochs: int = 1         # PPO epochs over each rollout (SF --ppo_epochs)
    num_minibatches: int = 1    # env-axis minibatches per epoch (SF num_batches_per_epoch)
    # Schedules (both need total_env_steps > 0): lr decays linearly
    # lr -> lr_final over the run; the exploration coefficient anneals
    # exploration_coeff -> exploration_final with training progress.
    lr_final: float = -1.0      # < 0: constant lr
    exploration_final: float = -1.0  # < 0: constant coefficient
    total_env_steps: float = 0.0
    hidden_size: int = 512
    use_rnn: bool = True
    rnn_num_layers: int = 2     # reference runs: --rnn_num_layers=2
    model_dtype: torch.dtype = torch.bfloat16  # the encoder's compute dtype


class RolloutBatch(NamedTuple):
    obs: torch.Tensor        # packed i32 [T, B, A, H, W]
    actions: torch.Tensor    # i64 [T, B, A, 6]
    logp: torch.Tensor       # f32 [T, B, A]
    value: torch.Tensor      # f32 [T, B, A]
    reward: torch.Tensor     # f32 [T, B, A]
    done: torch.Tensor       # bool [T, B]
    init_carry: torch.Tensor  # f32 [B, A, carry]


class LearnerState(NamedTuple):
    params: Params
    opt_state: Dict[str, Any]
    env_state: Optional[EnvState]   # batched [B, ...]
    obs: torch.Tensor        # packed i32 [B, A, H, W] current observations
    carry: torch.Tensor      # f32 [B, A, carry] RNN state
    rng: torch.Generator     # on the learner's device: actions, minibatch order
    step: int                # env steps so far


def adam_init(params: Params) -> Dict[str, Any]:
    """optax.adam's state (ScaleByAdamState; a schedule's own count always
    equals `count`)."""
    return {"count": 0,
            "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()}}


def linear_schedule(init: float, end: float, steps: int, count: int) -> np.float32:
    """optax.linear_schedule(init, end, steps) at `count`, in float32."""
    frac = np.float32(1) - np.float32(min(max(count, 0), steps)) / np.float32(steps)
    return np.float32(init - end) * frac + np.float32(end)


def clip_by_global_norm(grads: Params, max_norm: float) -> Params:
    """optax.clip_by_global_norm: g / norm * max_norm where norm >= max_norm."""
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    keep = g_norm < max_norm
    return {k: torch.where(keep, g, g / g_norm * max_norm) for k, g in grads.items()}


def adam_update(grads: Params, state: Dict[str, Any], params: Params, lr: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
                ) -> Tuple[Params, Dict[str, Any]]:
    """optax.adam(lr) then optax.apply_updates: first and second moments,
    bias correction at the incremented count in float32, step
    m / (sqrt(v) + eps) scaled by -lr. Returns (new params, new state)."""
    count = state["count"] + 1
    new_params, mu, nu = {}, {}, {}
    for k, g in grads.items():
        m = (1 - b1) * g + b1 * state["mu"][k]
        v = (1 - b2) * (g * g) + b2 * state["nu"][k]
        one = torch.ones((), dtype=torch.float32, device=g.device)
        bc1 = one - torch.full((), b1, dtype=torch.float32, device=g.device) ** count
        bc2 = one - torch.full((), b2, dtype=torch.float32, device=g.device) ** count
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        new_params[k] = params[k] + u * -lr
        mu[k], nu[k] = m, v
    return new_params, {"count": count, "mu": mu, "nu": nu}


def opt_state_to_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    return {"count": int(state["count"]),
            "mu": {k: v.detach().cpu().numpy() for k, v in state["mu"].items()},
            "nu": {k: v.detach().cpu().numpy() for k, v in state["nu"].items()}}


def opt_state_from_numpy(state: Dict[str, Any], device) -> Dict[str, Any]:
    return {"count": int(state["count"]),
            "mu": {k: torch.from_numpy(np.array(v)).to(device) for k, v in state["mu"].items()},
            "nu": {k: torch.from_numpy(np.array(v)).to(device) for k, v in state["nu"].items()}}


class Learner:
    """Rollout and PPO update for one scenario's env batch on one device.

    `device=None` means "cuda" and raises if no GPU is present (as for
    VectorEnv); pass device="cpu" to run on the CPU. `capture` (default True):
    on a CUDA device the rollout replays the env tick from a CUDA graph
    (`capture.TickGraphs`), False runs it eagerly; `graph_pool` is the graph
    memory pool to share with the learners of other tasks (None: its own)."""

    def __init__(self, scenario: Scenario, num_envs: int, cfg: TrainConfig = TrainConfig(),
                 render_bucket: Optional[tuple] = None, device=None, capture: bool = True,
                 graph_pool=None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("the learner runs on a CUDA device by default and none "
                                   "is available; pass device='cpu' to run on the CPU")
            device = "cuda"
        self.scenario = scenario
        self.num_envs = num_envs
        self.cfg = cfg
        self.device = torch.device(device)
        # (max live boxes, max live props) across the env batch: slices the
        # render tables (see env.render_batch). Supplied by the caller from
        # generated-layout counts; None renders full capacity.
        self.render_bucket = render_bucket
        # the render kernel's form, read from the environment once (B2 unless
        # MEGAVERSE_RENDER_MODE and friends say otherwise), as VectorEnv does
        self.render_mode = RenderMode.from_env()
        scen = scenario.cfg
        self.model = ActorCritic(hidden_size=cfg.hidden_size, use_rnn=cfg.use_rnn,
                                 rnn_num_layers=cfg.rnn_num_layers, dtype=cfg.model_dtype,
                                 obs_height=scen.obs_height, obs_width=scen.obs_width
                                 ).to(self.device)
        self.ticks = TickGraphs(scenario, self.device, capture=capture, pool=graph_pool)
        self.lr_steps = 0
        if cfg.lr_final >= 0.0 and cfg.total_env_steps > 0:
            # linear decay over the planned number of optimizer updates
            per_update = cfg.rollout * num_envs
            self.lr_steps = max(1, int(cfg.total_env_steps / per_update)) \
                * max(1, cfg.num_epochs) * max(1, cfg.num_minibatches)

    def learning_rate(self, count: int) -> float:
        cfg = self.cfg
        if self.lr_steps:
            return float(linear_schedule(cfg.lr, cfg.lr_final, self.lr_steps, count))
        return cfg.lr

    # ------------------------------------------------------------------ init
    def init(self, seed: int, env_state: Optional[EnvState], obs: torch.Tensor
             ) -> LearnerState:
        """Fresh parameters (flax's initializers, drawn from `seed`), zero
        carry (one per env of `obs`: all `num_envs`, or one rank's share of
        them under parallel.ParallelLearner), Adam state and the learner's
        generator."""
        self.model.reset_parameters(torch.Generator(self.device).manual_seed(seed))
        params = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        b, a = obs.shape[0], self.scenario.cfg.num_agents
        carry = self.model.initial_carry((b, a), self.device)
        rng = torch.Generator(self.device).manual_seed(seed + 1)
        return LearnerState(params, adam_init(params), env_state, obs, carry, rng, 0)

    # --------------------------------------------------------------- rollout
    def _policy(self, params: Params, obs: torch.Tensor, carry: torch.Tensor):
        return functional_call(self.model, params, (obs, carry))

    @torch.no_grad()
    def collect_rollout(self, ls: LearnerState, next_scenes: SceneData,
                        shaping: torch.Tensor) -> Tuple[LearnerState, RolloutBatch]:
        """`cfg.rollout` steps of every env: policy, sampled actions, the env
        tick (as VectorEnv's: the reference's deferred auto-reset where it
        takes one, one render launch), its outputs written into this
        rollout's buffers. The carry is zeroed where an env finished; rewards
        are clipped. The first rollout over a state (or new `next_scenes` /
        `shaping` objects) binds a copy of it in the tick's buffers; the
        returned `env_state` is that copy, advanced in place by later
        rollouts. `next_scenes` and `shaping` must change only in place.
        Spans: "megaverse.rollout", in it per step "megaverse.rollout.policy",
        "megaverse.rollout.sample" and the tick's "megaverse.tick"."""
        with span("megaverse.rollout"):
            cfg, ticks = self.cfg, self.ticks
            if not ticks.is_bound(ls.env_state, next_scenes, shaping):
                ls = ls._replace(env_state=ticks.bind(ls.env_state, next_scenes, shaping))
            fresh = (lambda x: x.clone()) if ticks.capture else (lambda x: x)
            steps = cfg.rollout
            obs_buf = torch.empty((steps,) + tuple(ls.obs.shape), dtype=ls.obs.dtype,
                                  device=ls.obs.device)
            obs_buf[0].copy_(ls.obs)
            rnn, bufs, obs = ls.carry, None, None
            for t in range(steps):
                with span("megaverse.rollout.policy"):
                    logits, value, rnn2 = self._policy(ls.params, obs_buf[t], rnn)
                with span("megaverse.rollout.sample"):
                    actions, logp = sample_actions(logits, ls.rng)
                    bits = multidiscrete_to_bitmask(actions)
                obs, reward, done, _ = ticks.run(bits, fmt="packed", bucket=self.render_bucket,
                                                 mode=self.render_mode)
                # reset the RNN state on episode boundaries
                rnn = torch.where(done[:, None, None], 0.0, rnn2)
                if cfg.reward_clip > 0:
                    reward = torch.clamp(reward, -cfg.reward_clip, cfg.reward_clip)
                row = (actions, logp, value, reward, done)
                if bufs is None:
                    bufs = [torch.empty((steps,) + tuple(x.shape), dtype=x.dtype,
                                        device=x.device) for x in row]
                for buf, x in zip(bufs, row):
                    buf[t].copy_(x)
                if t + 1 < steps:
                    obs_buf[t + 1].copy_(obs)
            batch = RolloutBatch(obs_buf, *bufs, init_carry=ls.carry)
            ls = ls._replace(obs=fresh(obs), carry=rnn,
                             step=ls.step + cfg.rollout * self.num_envs)
            return ls, batch

    # ------------------------------------------------------------------ loss
    def _forward_sequence(self, params: Params, batch: RolloutBatch):
        """Logits and values over the rollout, recomputed from the stored
        initial carry (truncated BPTT, APPO-style), the carry zeroed after
        each done step."""
        logits, values, _ = functional_call(self.model, params, (batch.obs, batch.init_carry),
                                            {"done": batch.done})
        return logits, values

    def _gae(self, batch: RolloutBatch, last_value: torch.Tensor):
        """GAE advantages (normalised by their population std) and returns over
        [T, B, A], computed once per rollout."""
        cfg = self.cfg
        done_f = batch.done[..., None].float()  # [T, B, 1]
        gae = torch.zeros_like(last_value)
        next_value = last_value
        advantages = [None] * batch.reward.shape[0]
        for t in reversed(range(batch.reward.shape[0])):
            nonterminal = 1.0 - done_f[t]
            delta = batch.reward[t] + cfg.gamma * next_value * nonterminal - batch.value[t]
            gae = delta + cfg.gamma * cfg.gae_lambda * nonterminal * gae
            advantages[t] = gae
            next_value = batch.value[t]
        advantages = torch.stack(advantages)
        returns = advantages + batch.value
        adv_std = torch.std(advantages, correction=0) + 1e-8
        norm_adv = (advantages - torch.mean(advantages)) / adv_std
        return norm_adv, returns

    def _loss(self, params: Params, batch: RolloutBatch, norm_adv, returns, progress=0.0):
        cfg = self.cfg
        logits, values = self._forward_sequence(params, batch)
        logp, entropy = action_log_prob_entropy(logits, batch.actions)
        ratio = torch.exp(logp - batch.logp)
        clipped = torch.clamp(ratio, 1.0 - cfg.clip_ratio, 1.0 + cfg.clip_ratio)
        policy_loss = -torch.mean(torch.minimum(ratio * norm_adv, clipped * norm_adv))
        value_loss = 0.5 * torch.mean((values - returns) ** 2)
        expl_loss = torch.mean(symmetric_kl_from_uniform(logits))
        expl_coeff = cfg.exploration_coeff
        if cfg.exploration_final >= 0.0:
            expl_coeff = (cfg.exploration_coeff + (cfg.exploration_final - cfg.exploration_coeff)
                          * min(max(progress, 0.0), 1.0))
        total = policy_loss + cfg.value_coeff * value_loss + expl_coeff * expl_loss
        metrics = {
            "loss": total.detach(),
            "policy_loss": policy_loss.detach(),
            "value_loss": value_loss.detach(),
            "exploration_loss": expl_loss.detach(),
            "entropy": torch.mean(entropy).detach(),
            "reward_mean": torch.mean(batch.reward),
        }
        return total, metrics

    def loss_and_grads(self, params: Params, batch: RolloutBatch, norm_adv, returns,
                       progress=0.0):
        """(loss, metrics, grads): `jax.value_and_grad(_loss, has_aux=True)`."""
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss, metrics = self._loss(leaves, batch, norm_adv, returns, progress)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), metrics, dict(zip(leaves, grads))

    # ------------------------------------------------------------ train step
    def train_step(self, ls: LearnerState, next_scenes: SceneData, shaping: torch.Tensor):
        """One rollout + one PPO update."""
        ls, batch = self.collect_rollout(ls, next_scenes, shaping)
        return self._update_from_batch(ls, batch)

    def _apply(self, params, opt_state, batch, norm_adv, returns, progress, pmean=None):
        _, metrics, grads = self.loss_and_grads(params, batch, norm_adv, returns, progress)
        if pmean is not None:
            grads, metrics = pmean(grads), pmean(metrics)
        with torch.no_grad():
            if self.cfg.max_grad_norm > 0:
                grads = clip_by_global_norm(grads, self.cfg.max_grad_norm)
            params, opt_state = adam_update(grads, opt_state, params,
                                            self.learning_rate(opt_state["count"]))
        return params, opt_state, metrics

    def _update_from_batch(self, ls: LearnerState, batch: RolloutBatch, pmean=None):
        """GAE and the PPO update(s) of one rollout. `pmean` (data parallel,
        parallel.ParallelLearner.pmean; the reference's `axis_name`) averages
        the gradients and metrics over the ranks after the backward pass,
        before the clip and Adam. Span: "megaverse.update"."""
        with span("megaverse.update"):
            with torch.no_grad():
                _, last_value, _ = self._policy(ls.params, ls.obs, ls.carry)
                norm_adv, returns = self._gae(batch, last_value)
            cfg = self.cfg
            n_mb = max(1, cfg.num_minibatches)
            params, opt_state = ls.params, ls.opt_state
            progress = ls.step / cfg.total_env_steps if cfg.total_env_steps > 0 else 0.0
            if cfg.num_epochs <= 1 and n_mb <= 1:
                params, opt_state, metrics = self._apply(params, opt_state, batch, norm_adv,
                                                         returns, progress, pmean)
            else:
                # Sequence-level minibatching (SF-style: whole rollouts per env,
                # the truncated-BPTT state stays valid); env axis shuffled per epoch.
                b = batch.reward.shape[1]   # this rank's envs
                if b % n_mb:
                    raise ValueError(f"num_envs {b} is not a multiple of num_minibatches "
                                     f"{n_mb}")
                for _ in range(max(1, cfg.num_epochs)):
                    perm = torch.randperm(b, generator=ls.rng, device=self.device)
                    for m in range(n_mb):
                        idx = perm[m * (b // n_mb):(m + 1) * (b // n_mb)]
                        params, opt_state, metrics = self._apply(
                            params, opt_state, minibatch(batch, idx),
                            norm_adv[:, idx], returns[:, idx], progress, pmean)
            return ls._replace(params=params, opt_state=opt_state), metrics


def minibatch(batch: RolloutBatch, idx: torch.Tensor) -> RolloutBatch:
    """The rows `idx` of the env axis (axis 1; axis 0 of init_carry)."""
    return RolloutBatch(*(x[:, idx] for x in batch[:-1]), init_carry=batch.init_carry[idx])
