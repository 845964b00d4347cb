"""The APPO configuration's policy and PPO update, written out in plain torch
from the configuration (megaverse_rl/megaverse_params.py, Sample Factory's
convnet_simple and APPO; optax's clip and Adam).

- Encoder: convolutions (32, 8, 4), (64, 4, 2), (128, 3, 2), then a dense
  layer to `hidden`, all computed in bfloat16 from float32 parameters: the
  input scaled to [0, 1] in bf16, every convolution and dense output rounded
  to bf16 before its bias and ReLU; activations flattened in (h, w, c) order.
- Core: stacked GRU cells, float32: r = sigmoid(W_ir x + b_ir + W_hr h),
  z = sigmoid(W_iz x + b_iz + W_hz h), n = tanh(W_in x + b_in + r (W_hn h +
  b_hn)), h' = (1 - z) n + z h; the carry zeroed after a step that ends an
  episode.
- Heads: six categorical heads (3, 3, 3, 2, 2, 3) and a value head, float32.
- Loss: PPO's clipped surrogate over advantages from GAE (normalised by their
  population standard deviation), half the squared value error, and the
  symmetric KL from the uniform policy as exploration loss.
- Update: the global-norm clip (scale by max / norm where norm >= max), then
  Adam (bias-corrected, eps outside the square root).

`tf32=True` is the lower-precision control: every float32 matrix product
takes operands rounded to TF32 (10 mantissa bits), as the tensor cores do.

Parameter names follow the program's state_dict, so that the benchmark can
hand the same tensors to both sides.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def param_shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    """{name: shape} of every parameter."""
    out: Dict[str, Tuple[int, ...]] = {}
    h, w, c = cfg["obs_height"], cfg["obs_width"], 3
    for i, (features, kernel, stride) in enumerate(cfg["conv_layers"]):
        out[f"encoder.convs.{i}.weight"] = (features, c, kernel, kernel)
        out[f"encoder.convs.{i}.bias"] = (features,)
        h, w, c = (h - kernel) // stride + 1, (w - kernel) // stride + 1, features
    hid = cfg["hidden_size"]
    out["encoder.dense.weight"] = (hid, h * w * c)
    out["encoder.dense.bias"] = (hid,)
    for layer in range(cfg["rnn_num_layers"]):
        for g in ("ir", "iz", "in_", "hr", "hz", "hn"):
            out[f"core.{layer}.{g}.weight"] = (hid, hid)
            if g not in ("hr", "hz"):
                out[f"core.{layer}.{g}.bias"] = (hid,)
    for i, n in enumerate(cfg["action_heads"]):
        out[f"action_heads.{i}.weight"] = (n, hid)
        out[f"action_heads.{i}.bias"] = (n,)
    out["value_head.weight"] = (1, hid)
    out["value_head.bias"] = (1,)
    return out


def make_params(cfg: Dict, seed: int, device) -> Params:
    """Parameters drawn on `device` from `seed` in one call: every weight a
    standard normal clipped at +-2 and scaled by 1 / (0.8796 sqrt(fan_in))
    (variance 1 / fan_in), every bias zero."""
    shapes = param_shapes(cfg)
    weights = {k: s for k, s in shapes.items() if k.endswith("weight")}
    total = sum(math.prod(s) for s in weights.values())
    g = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    z = torch.randn(total, generator=g, device=device, dtype=torch.float32).clamp_(-2.0, 2.0)
    out, at = {}, 0
    for k, s in shapes.items():
        if k not in weights:
            out[k] = torch.zeros(s, dtype=torch.float32, device=device)
            continue
        n = math.prod(s)
        fan_in = math.prod(s[1:])
        out[k] = (z[at:at + n].reshape(s) / (0.87962566103423978 * math.sqrt(fan_in))).clone()
        at += n
    return out


# ------------------------------------------------------------------ network
def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (nearest, ties away)."""
    bits = x.detach().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32Linear(torch.autograd.Function):
    """x @ w.T with every operand of the forward and backward products
    rounded to TF32, accumulated in float32."""

    @staticmethod
    def forward(ctx, x, w):
        x, w = _tf32(x), _tf32(w)
        ctx.save_for_backward(x, w)
        return F.linear(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = _tf32(g)
        gw = g.reshape(-1, g.shape[-1]).t() @ x.reshape(-1, x.shape[-1])
        return g @ w, gw


def _linear(x, w, b=None, tf32=False):
    if not tf32:
        return F.linear(x, w, b)
    y = _TF32Linear.apply(x, w)
    return y if b is None else y + b


def channels(obs: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """Packed int32 frames [..., H, W] -> (uint8-valued channels [N, 3, H,
    W] as int32, the leading shape)."""
    lead = tuple(obs.shape[:-2])
    x = torch.stack([(obs >> 16) & 0xFF, (obs >> 8) & 0xFF, obs & 0xFF], dim=-3)
    return x.reshape((-1,) + tuple(x.shape[-3:])), lead


def encode(p: Params, cfg: Dict, obs: torch.Tensor) -> torch.Tensor:
    x, lead = channels(obs)
    bf = torch.bfloat16
    x = x.to(bf) / torch.full((), 255.0, dtype=bf, device=x.device)
    for i, (_, _, stride) in enumerate(cfg["conv_layers"]):
        x = F.conv2d(x, p[f"encoder.convs.{i}.weight"].to(bf), stride=stride)
        x = torch.relu(x + p[f"encoder.convs.{i}.bias"].to(bf)[:, None, None])
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = torch.relu(F.linear(x, p["encoder.dense.weight"].to(bf)) + p["encoder.dense.bias"].to(bf))
    return x.reshape(lead + (cfg["hidden_size"],)).to(torch.float32)


def gru(p: Params, layer: int, h: torch.Tensor, x: torch.Tensor, tf32=False) -> torch.Tensor:
    k = lambda g, part: p.get(f"core.{layer}.{g}.{part}")
    r = torch.sigmoid(_linear(x, k("ir", "weight"), k("ir", "bias"), tf32)
                      + _linear(h, k("hr", "weight"), None, tf32))
    z = torch.sigmoid(_linear(x, k("iz", "weight"), k("iz", "bias"), tf32)
                      + _linear(h, k("hz", "weight"), None, tf32))
    n = torch.tanh(_linear(x, k("in_", "weight"), k("in_", "bias"), tf32)
                   + r * _linear(h, k("hn", "weight"), k("hn", "bias"), tf32))
    return (1.0 - z) * n + z * h


def core(p: Params, cfg: Dict, x: torch.Tensor, carry: torch.Tensor, tf32=False):
    hid = cfg["hidden_size"]
    layers = []
    for li in range(cfg["rnn_num_layers"]):
        x = gru(p, li, carry[..., li * hid:(li + 1) * hid], x, tf32)
        layers.append(x)
    return x, torch.cat(layers, dim=-1)


def heads(p: Params, cfg: Dict, x: torch.Tensor, tf32=False):
    logits = [_linear(x, p[f"action_heads.{i}.weight"], p[f"action_heads.{i}.bias"], tf32)
              for i in range(len(cfg["action_heads"]))]
    value = _linear(x, p["value_head.weight"], p["value_head.bias"], tf32)[..., 0]
    return logits, value


def forward_sequence(p: Params, cfg: Dict, obs: torch.Tensor, carry: torch.Tensor,
                     done: torch.Tensor, tf32=False):
    """obs [T, B, A, H, W] from `carry` [B, A, C]: (logits per head [T, B,
    A, n], values [T, B, A], the carry after the last step)."""
    x = encode(p, cfg, obs)
    outs = []
    for t in range(x.shape[0]):
        out, carry = core(p, cfg, x[t], carry, tf32)
        carry = torch.where(done[t][:, None, None], 0.0, carry)
        outs.append(out)
    logits, value = heads(p, cfg, torch.stack(outs), tf32)
    return logits, value, carry


def log_prob_entropy(logits: Sequence[torch.Tensor], actions: torch.Tensor):
    logp, ent = 0.0, 0.0
    for i, lg in enumerate(logits):
        ls = torch.log_softmax(lg, dim=-1)
        logp = logp + ls.gather(-1, actions[..., i:i + 1].long())[..., 0]
        ent = ent - torch.sum(torch.exp(ls) * ls, dim=-1)
    return logp, ent


def symmetric_kl(logits: Sequence[torch.Tensor]) -> torch.Tensor:
    total = 0.0
    for lg in logits:
        ls = torch.log_softmax(lg, dim=-1)
        log_u = -math.log(lg.shape[-1])
        total = total + torch.sum(torch.exp(ls) * (ls - log_u), dim=-1) \
            + torch.sum(math.exp(log_u) * (log_u - ls), dim=-1)
    return total


# ------------------------------------------------------------------- update
def gae(cfg: Dict, reward, value, done, last_value):
    """Normalised GAE advantages and returns over [T, B, A]."""
    gamma, lam = cfg["gamma"], cfg["gae_lambda"]
    done_f = done[..., None].float()
    adv = torch.zeros_like(last_value)
    nxt = last_value
    out: List[torch.Tensor] = [None] * reward.shape[0]
    for t in reversed(range(reward.shape[0])):
        nonterminal = 1.0 - done_f[t]
        delta = reward[t] + gamma * nxt * nonterminal - value[t]
        adv = delta + gamma * lam * nonterminal * adv
        out[t] = adv
        nxt = value[t]
    adv = torch.stack(out)
    returns = adv + value
    norm = (adv - adv.mean()) / (torch.std(adv, correction=0) + 1e-8)
    return norm, returns


def loss_and_grads(p: Params, cfg: Dict, batch: Dict[str, torch.Tensor],
                   last_obs: torch.Tensor, tf32=False):
    """(loss, gradients) of one PPO step on a rollout `batch` (obs, actions,
    logp, value, reward, done, init_carry) whose last observation is
    `last_obs`; the carry after the rollout is worked out by the forward."""
    with torch.no_grad():
        _, _, carry = forward_sequence(p, cfg, batch["obs"], batch["init_carry"], batch["done"],
                                       tf32)
        x = encode(p, cfg, last_obs)
        out, _ = core(p, cfg, x, carry, tf32)
        _, last_value = heads(p, cfg, out, tf32)
        norm_adv, returns = gae(cfg, batch["reward"], batch["value"], batch["done"], last_value)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    logits, values, _ = forward_sequence(leaves, cfg, batch["obs"], batch["init_carry"],
                                         batch["done"], tf32)
    logp, _ = log_prob_entropy(logits, batch["actions"])
    ratio = torch.exp(logp - batch["logp"])
    clip = cfg["ppo_clip_ratio"]
    clipped = torch.clamp(ratio, 1.0 - clip, 1.0 + clip)
    policy_loss = -torch.mean(torch.minimum(ratio * norm_adv, clipped * norm_adv))
    value_loss = 0.5 * torch.mean((values - returns) ** 2)
    expl = torch.mean(symmetric_kl(logits))
    total = policy_loss + cfg["value_loss_coeff"] * value_loss \
        + cfg["exploration_loss_coeff"] * expl
    grads = torch.autograd.grad(total, list(leaves.values()))
    return total.detach(), dict(zip(leaves, grads))


def clip_global_norm(grads: Params, max_norm: float) -> Params:
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    keep = norm < max_norm
    return {k: torch.where(keep, g, g / norm * max_norm) for k, g in grads.items()}


def adam(p: Params, grads: Params, state: Dict, cfg: Dict) -> Tuple[Params, Dict]:
    b1, b2, eps = cfg["adam"]["b1"], cfg["adam"]["b2"], cfg["adam"]["eps"]
    count = state["count"] + 1
    new_p, mu, nu = {}, {}, {}
    for k, g in grads.items():
        m = (1 - b1) * g + b1 * state["mu"][k]
        v = (1 - b2) * (g * g) + b2 * state["nu"][k]
        one = torch.ones((), dtype=torch.float32, device=g.device)
        bc1 = one - torch.full((), b1, dtype=torch.float32, device=g.device) ** count
        bc2 = one - torch.full((), b2, dtype=torch.float32, device=g.device) ** count
        new_p[k] = p[k] + ((m / bc1) / (torch.sqrt(v / bc2) + eps)) * -cfg["learning_rate"]
        mu[k], nu[k] = m, v
    return new_p, {"count": count, "mu": mu, "nu": nu}


def adam_init(p: Params) -> Dict:
    return {"count": 0, "mu": {k: torch.zeros_like(v) for k, v in p.items()},
            "nu": {k: torch.zeros_like(v) for k, v in p.items()}}


def policy_outputs(p: Params, cfg: Dict, batch: Dict[str, torch.Tensor], tf32=False):
    """The rollout's log-probabilities of its actions and its values,
    recomputed step by step as the rollout ran (the carry zeroed after a
    step that ended an episode)."""
    carry = batch["init_carry"]
    logps, values = [], []
    for t in range(batch["obs"].shape[0]):
        x = encode(p, cfg, batch["obs"][t])
        out, new = core(p, cfg, x, carry, tf32)
        logits, value = heads(p, cfg, out, tf32)
        logp, _ = log_prob_entropy(logits, batch["actions"][t])
        logps.append(logp)
        values.append(value)
        carry = torch.where(batch["done"][t][:, None, None], 0.0, new)
    return torch.stack(logps), torch.stack(values)
