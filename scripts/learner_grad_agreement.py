"""How far the learner's gradients on the card and on the CPU lie apart, and why.

`chip_smoke.py` holds the learner's update on the card against the same
update on the CPU. This script measures what that comparison can expect, on
the same inputs (`chip_smoke.update_check_inputs`: numpy seed 0, 8 envs x 2
agents x 32 steps, 72x128, hidden 512):

  1. the PPO loss's gradients in float64 on the CPU (the reference), and in
     float32 and bfloat16 on the CPU and on the card (cuDNN as configured,
     cuDNN off, cuDNN deterministic), each as its distance from the reference
     and from the CPU at the same dtype (relative to the gradient's norm),
     with the three tensors farthest from the reference;
  2. the ReLU units of the encoder's three convolutions whose gate (input
     > 0) differs between the card's and the CPU's float32 forward on the
     rollout's observations, per layer;
  3. on the CPU alone, the three convolutions with ReLUs on random inputs in
     float32 and float64: per layer, the ReLU units whose gate differs
     between the two, and the relative error of the gradient at the layer's
     output and of its weight gradient.

    python3 scripts/learner_grad_agreement.py          # GPU
    python3 scripts/learner_grad_agreement.py --cpu    # part 3 and the CPU rows only

Prints one JSON line per row; the card's name and power limit are in the
first line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

from chip_smoke import update_check_inputs, update_check_setup  # noqa: E402


def grads(dev, dtype, inputs):
    learner, ls, batch = update_check_setup(torch.device(dev), dtype, inputs)
    with torch.no_grad():
        _, last_value, _ = learner._policy(ls.params, ls.obs, ls.carry)
        adv, ret = learner._gae(batch, last_value)
    loss, _, g = learner.loss_and_grads(ls.params, batch, adv, ret)
    return float(loss), {k: v.double().cpu() for k, v in g.items()}


def rel(a, b):
    num = sum(((a[k] - b[k]) ** 2).sum().item() for k in b)
    return (num / sum((b[k] ** 2).sum().item() for k in b)) ** 0.5


def conv_gates(dev, inputs):
    """The ReLU gates of the encoder's convolutions (float32) on the rollout's
    observations."""
    from megaverse_tpu_torch.models.actor_critic import obs_channels

    batch_np, _, _, params = inputs
    x, _ = obs_channels(torch.from_numpy(batch_np["obs"]).to(dev))
    x = x.float() / torch.full((), 255.0, device=dev)
    gates = []
    for i, stride in enumerate((4, 2, 2)):
        w, b = (params[f"encoder.convs.{i}.{n}"].to(dev) for n in ("weight", "bias"))
        x = F.conv2d(x, w, stride=stride) + b[:, None, None]
        gates.append((x > 0).cpu())
        x = torch.relu(x)
    return gates


def relu_kinks():
    """Part 3: the convolutions alone, float32 against float64."""
    rng = np.random.default_rng(0)
    n = 512
    x = rng.integers(0, 256, (n, 3, 72, 128)).astype(np.float64) / 255
    ws = [rng.normal(0, s, shape) for s, shape in
          ((0.07, (32, 3, 8, 8)), (0.04, (64, 32, 4, 4)), (0.04, (128, 64, 3, 3)))]
    g_out = rng.normal(0, 1e-3, (n, 128, 3, 6))

    def run(dtype):
        w = [torch.tensor(v, dtype=dtype, requires_grad=True) for v in ws]
        h, pre = torch.tensor(x, dtype=dtype), []
        for wi, stride in zip(w, (4, 2, 2)):
            h = F.conv2d(h, wi, stride=stride)
            h.retain_grad()
            pre.append(h)
            h = torch.relu(h)
        (h * torch.tensor(g_out, dtype=dtype)).sum().backward()
        return ([p.detach().double() for p in pre], [p.grad.double() for p in pre],
                [wi.grad.double() for wi in w])

    ref, got = run(torch.float64), run(torch.float32)
    err = lambda a, b: float((a - b).norm() / b.norm())
    for i in range(3):
        print(json.dumps({
            "part": "relu_kinks", "layer": i, "device": "cpu",
            "relu_units_flipped": int(((got[0][i] > 0) != (ref[0][i] > 0)).sum()),
            "grad_at_output_rel_err": err(got[1][i], ref[1][i]),
            "weight_grad_rel_err": err(got[2][i], ref[2][i])}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true", help="skip the card's rows")
    args = ap.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        print("learner_grad_agreement: no CUDA device (use --cpu)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = None if args.cpu else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"part": "machine", "gpu": gpu, "torch": torch.__version__}), flush=True)
    inputs = update_check_inputs()
    _, ref = grads("cpu", torch.float64, inputs)
    rows = [("cpu", torch.float32, "default"), ("cpu", torch.bfloat16, "default")]
    if not args.cpu:
        rows += [("cuda", dt, mode) for mode in ("default", "cudnn_off", "cudnn_deterministic")
                 for dt in (torch.float32, torch.bfloat16)]
    same = {}
    for dev, dtype, mode in rows:
        torch.backends.cudnn.enabled = mode != "cudnn_off"
        torch.backends.cudnn.deterministic = mode == "cudnn_deterministic"
        loss, g = grads(dev, dtype, inputs)
        name = str(dtype).split(".")[-1]
        if dev == "cpu":
            same[name] = (loss, g)
        worst = sorted(((float((g[k] - ref[k]).norm() / ref[k].norm()), k) for k in ref),
                       reverse=True)[:3]
        print(json.dumps({
            "part": "gradients", "device": dev, "dtype": name, "cudnn": mode, "loss": loss,
            "rel_err_vs_float64": rel(g, ref),
            "rel_err_vs_cpu_same_dtype": rel(g, same[name][1]),
            "loss_rel_err_vs_cpu_same_dtype": abs(loss - same[name][0]) / abs(same[name][0]),
            "worst_tensors_vs_float64": worst}), flush=True)
    if not args.cpu:
        with torch.no_grad():
            card, cpu = conv_gates("cuda", inputs), conv_gates("cpu", inputs)
        for i, (a, b) in enumerate(zip(card, cpu)):
            print(json.dumps({"part": "relu_gates_card_vs_cpu", "layer": i,
                              "units": int(a.numel()),
                              "units_whose_gate_differs": int((a != b).sum())}), flush=True)
    relu_kinks()
    return 0


if __name__ == "__main__":
    sys.exit(main())
