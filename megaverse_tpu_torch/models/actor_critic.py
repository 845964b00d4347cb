"""Policy / value network for RL training (counterpart of
megaverse_tpu/models/actor_critic.py).

The reference training setup (megaverse_rl/megaverse_params.py:4-21:
encoder_type=conv, encoder_subtype=convnet_simple, hidden_size=512,
obs_scale=255): Sample Factory's "convnet_simple", conv(32,8x8,s4) ->
conv(64,4x4,s2) -> conv(128,3x3,s2) -> FC(512), a stacked GRU core (README
training command: rollout/recurrence 32, --rnn_num_layers=2) and six
independent categorical heads for the reference action space
Tuple(3,3,3,2,2,3) (env.cpp:33), plus a value head.

The network computes what the flax one computes, parameter for parameter
(`convert.actor_critic_from_flax` carries flax weights across):

- The encoder runs in `dtype` (bfloat16 by default) with float32 parameters.
  Inputs and weights are cast at use, and every convolution and dense output
  is rounded to `dtype` before its bias is added and before the ReLU, as flax
  does (no autocast, which keeps some ops in float32).
- The GRU is flax's `GRUCell`, not `torch.nn.GRUCell`: no hidden-side bias on
  the r and z gates, float32 throughout. The carry of all layers is packed
  into one [..., layers * hidden] tensor.
- Flax convolutions are NHWC: the activations are flattened in (h, w, c)
  order before the dense layer, so its weight is flax's kernel transposed.
- A fresh model takes flax's initializers: lecun-normal kernels (a normal
  truncated at two standard deviations), orthogonal recurrent kernels, zero
  biases.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from megaverse_tpu_torch import constants as C

ACTION_HEADS: Tuple[int, ...] = C.ACTION_SPACE_SIZES  # (3, 3, 3, 2, 2, 3)
# (features, kernel, stride) of the encoder's convolutions
CONV_LAYERS = ((32, 8, 4), (64, 4, 2), (128, 3, 2))


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's default kernel initializer, variance_scaling(1, "fan_in",
    "truncated_normal"): a normal truncated at +-2 standard deviations and
    rescaled so that the variance is 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


def obs_channels(obs: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """uint8 [..., H, W, 3] or packed-RGB int32 [..., H, W] -> (channels
    [N, 3, H, W] in the input's integer dtype, the leading batch shape)."""
    if obs.dtype in (torch.int32, torch.int64):
        batch = tuple(obs.shape[:-2])
        x = torch.stack([(obs >> 16) & 0xFF, (obs >> 8) & 0xFF, obs & 0xFF], dim=-3)
    else:
        batch = tuple(obs.shape[:-3])
        x = obs.movedim(-1, -3)
    return x.reshape((-1,) + tuple(x.shape[-3:])), batch


class ConvEncoder(nn.Module):
    """Sample Factory convnet_simple: 32x8s4, 64x4s2, 128x3s2 -> FC(hidden)."""

    def __init__(self, hidden_size: int = 512, dtype: torch.dtype = torch.bfloat16,
                 obs_height: int = C.OBS_HEIGHT, obs_width: int = C.OBS_WIDTH):
        super().__init__()
        self.hidden_size = hidden_size
        self.dtype = dtype
        convs = []
        cin, h, w = 3, obs_height, obs_width
        for features, kernel, stride in CONV_LAYERS:
            convs.append(nn.Conv2d(cin, features, kernel, stride=stride))
            cin, h, w = features, (h - kernel) // stride + 1, (w - kernel) // stride + 1
        self.convs = nn.ModuleList(convs)
        self.dense = nn.Linear(h * w * cin, hidden_size)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        """obs uint8 [..., H, W, 3] or packed int32 [..., H, W] -> float32
        features [..., hidden] (float64 for a float64 model, which serves as
        a reference)."""
        x, batch = obs_channels(obs)
        dt = self.dtype
        # a divisor on the input's device: a python scalar would make CUDA
        # multiply by its rounded reciprocal
        x = x.to(dt) / torch.full((), 255.0, dtype=dt, device=x.device)
        for conv in self.convs:
            x = F.conv2d(x, conv.weight.to(dt), stride=conv.stride)
            x = torch.relu(x + conv.bias.to(dt)[:, None, None])
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)     # (h, w, c) order
        x = torch.relu(F.linear(x, self.dense.weight.to(dt)) + self.dense.bias.to(dt))
        return x.reshape(batch + (self.hidden_size,)).to(torch.promote_types(dt, torch.float32))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for conv in self.convs:
            fan_in = conv.in_channels * conv.kernel_size[0] * conv.kernel_size[1]
            lecun_normal_(conv.weight, fan_in, generator)
            nn.init.zeros_(conv.bias)
        lecun_normal_(self.dense.weight, self.dense.in_features, generator)
        nn.init.zeros_(self.dense.bias)


class GRUCell(nn.Module):
    """flax.linen.GRUCell:
        r = sigmoid(ir(x) + hr(h))
        z = sigmoid(iz(x) + hz(h))
        n = tanh(in(x) + r * hn(h))
        h' = (1 - z) * n + z * h
    `ir`, `iz`, `in` (here `in_`) and `hn` carry a bias, `hr` and `hz` do not."""

    def __init__(self, features: int):
        super().__init__()
        self.ir = nn.Linear(features, features)
        self.iz = nn.Linear(features, features)
        self.in_ = nn.Linear(features, features)
        self.hr = nn.Linear(features, features, bias=False)
        self.hz = nn.Linear(features, features, bias=False)
        self.hn = nn.Linear(features, features)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        r = torch.sigmoid(self.ir(x) + self.hr(h))
        z = torch.sigmoid(self.iz(x) + self.hz(h))
        n = torch.tanh(self.in_(x) + r * self.hn(h))
        return (1.0 - z) * n + z * h

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for lin in (self.ir, self.iz, self.in_):
            lecun_normal_(lin.weight, lin.in_features, generator)
        for lin in (self.hr, self.hz, self.hn):
            nn.init.orthogonal_(lin.weight, generator=generator)
        for lin in (self.ir, self.iz, self.in_, self.hn):
            nn.init.zeros_(lin.bias)


class ActorCritic(nn.Module):
    """Conv encoder + optional stacked-GRU core + 6 categorical heads + value
    head. `dtype` is the encoder's compute dtype (parameters stay float32)."""

    def __init__(self, hidden_size: int = 512, use_rnn: bool = True,
                 rnn_num_layers: int = 2, dtype: torch.dtype = torch.bfloat16,
                 obs_height: int = C.OBS_HEIGHT, obs_width: int = C.OBS_WIDTH,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.use_rnn = use_rnn
        self.rnn_num_layers = rnn_num_layers
        self.dtype = dtype
        self.encoder = ConvEncoder(hidden_size, dtype, obs_height, obs_width)
        self.core = nn.ModuleList(
            [GRUCell(hidden_size) for _ in range(rnn_num_layers if use_rnn else 0)])
        self.action_heads = nn.ModuleList([nn.Linear(hidden_size, n) for n in ACTION_HEADS])
        self.value_head = nn.Linear(hidden_size, 1)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's initializers (see the module docstring), drawn from
        `generator` (the default generator of the parameters' device if None)."""
        with torch.no_grad():
            self.encoder.reset_parameters(generator)
            for cell in self.core:
                cell.reset_parameters(generator)
            for head in list(self.action_heads) + [self.value_head]:
                lecun_normal_(head.weight, head.in_features, generator)
                nn.init.zeros_(head.bias)

    @property
    def carry_size(self) -> int:
        return self.hidden_size * (self.rnn_num_layers if self.use_rnn else 1)

    def initial_carry(self, batch_shape: Tuple[int, ...], device=None) -> torch.Tensor:
        return torch.zeros(tuple(batch_shape) + (self.carry_size,), dtype=torch.float32,
                           device=device)

    def core_step(self, x: torch.Tensor, carry: torch.Tensor):
        """One step of the recurrent core: features [..., hidden] and the
        packed carry -> (output [..., hidden], new packed carry)."""
        if not self.use_rnn:
            return x, carry
        h = self.hidden_size
        layers = []
        for li, cell in enumerate(self.core):
            x = cell(carry[..., li * h:(li + 1) * h], x)
            layers.append(x)
        return x, torch.cat(layers, dim=-1)

    def heads(self, x: torch.Tensor):
        """Core output [..., hidden] -> (logits tuple, value [...])."""
        logits = tuple(head(x) for head in self.action_heads)
        return logits, self.value_head(x)[..., 0]

    def forward(self, obs: torch.Tensor, carry: Optional[torch.Tensor] = None,
                done: Optional[torch.Tensor] = None):
        """obs [..., H, W, 3] uint8 or packed [..., H, W] int32 ->
        (logits tuple, value [...], new carry).

        With `done` (bool [T, B]) obs is a sequence [T, B, ...]: the encoder
        runs on all T steps at once, the core steps through them from `carry`
        and zeroes the carry after each step where `done` is set (the heads
        see the step's output before that reset); the returned carry is the
        one after the last step."""
        x = self.encoder(obs)
        if carry is None:
            carry = self.initial_carry(x.shape[:-1] if done is None else x.shape[1:-1],
                                       x.device)
        if done is None:
            x, carry = self.core_step(x, carry)
        else:
            outs = []
            for t in range(x.shape[0]):
                out, carry = self.core_step(x[t], carry)
                reset = done[t].reshape(done[t].shape + (1,) * (carry.dim() - done[t].dim()))
                carry = torch.where(reset, 0.0, carry)
                outs.append(out)
            x = torch.stack(outs)
        logits, value = self.heads(x)
        return logits, value, carry


def sample_actions(logits: Sequence[torch.Tensor], generator: torch.Generator
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample multidiscrete actions by the Gumbel-max trick (as
    jax.random.categorical) from `generator`, which lives on the logits'
    device; returns (actions int64 [..., 6], logp [...])."""
    acts = []
    logp = 0.0
    for lg in logits:
        u = torch.rand(lg.shape, generator=generator, device=lg.device, dtype=lg.dtype)
        a = torch.argmax(lg - torch.log(-torch.log(u)), dim=-1)
        logp = logp + torch.log_softmax(lg, dim=-1).gather(-1, a[..., None])[..., 0]
        acts.append(a)
    return torch.stack(acts, dim=-1), logp


def action_log_prob_entropy(logits: Sequence[torch.Tensor], actions: torch.Tensor):
    """(logp [...], entropy [...]) for multidiscrete actions [..., 6]."""
    logp = 0.0
    ent = 0.0
    actions = actions.long()
    for i, lg in enumerate(logits):
        ls = torch.log_softmax(lg, dim=-1)
        logp = logp + ls.gather(-1, actions[..., i][..., None])[..., 0]
        ent = ent - torch.sum(torch.exp(ls) * ls, dim=-1)
    return logp, ent


def symmetric_kl_from_uniform(logits: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sample Factory's symmetric_kl exploration loss (megaverse_params.py:16-17):
    the symmetric KL divergence between the policy and the uniform one."""
    total = 0.0
    for lg in logits:
        ls = torch.log_softmax(lg, dim=-1)
        p = torch.exp(ls)
        log_u = -math.log(lg.shape[-1])
        kl_pu = torch.sum(p * (ls - log_u), dim=-1)
        kl_up = torch.sum(math.exp(log_u) * (log_u - ls), dim=-1)
        total = total + kl_pu + kl_up
    return total
