"""The model FLOPs the APPO configuration needs, counted from its shapes
(one multiply-add = 2 FLOPs).

Per sample the policy's forward runs once in the rollout; the update runs it
again and its backward, which costs twice the forward but for the first
convolution's input gradient, which nothing needs (the observations are not
learned). Element-wise work (activations, the GRU's gates, softmaxes) is
left out: it is a rounding of the total.
"""

from __future__ import annotations

from typing import Dict


def layer_macs(cfg: Dict) -> Dict[str, int]:
    """Multiply-adds of one sample's forward, by layer."""
    h, w, c = cfg["obs_height"], cfg["obs_width"], 3
    out: Dict[str, int] = {}
    for i, (features, kernel, stride) in enumerate(cfg["conv_layers"]):
        h, w = (h - kernel) // stride + 1, (w - kernel) // stride + 1
        out[f"conv{i}"] = h * w * features * c * kernel * kernel
        c = features
    hidden = cfg["hidden_size"]
    out["fc"] = h * w * c * hidden
    out["gru"] = cfg["rnn_num_layers"] * 6 * hidden * hidden
    out["heads"] = hidden * (sum(cfg["action_heads"]) + 1)
    return out


def forward_flops(cfg: Dict) -> int:
    return 2 * sum(layer_macs(cfg).values())


def train_flops(cfg: Dict, samples: int) -> float:
    """FLOPs of `samples` env steps x agents trained: the rollout's forward,
    the update's forward and backward."""
    macs = layer_macs(cfg)
    fwd = 2 * sum(macs.values())
    bwd = 2 * fwd - 2 * macs["conv0"]
    return float(samples) * (fwd + fwd + bwd)
