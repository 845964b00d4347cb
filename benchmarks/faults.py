"""Faults planted in the program under test, to show that the comparisons
that decide `correct` catch them. The benchmark's own runs never plant one:
the tests under `tests/` (on the CPU, at a small size) and `control.py` (on
the card, at the cell's size) do.

Each fault patches the program in this process and returns a function that
takes the patch out again.

- `state_unchanged`: the sampler's tick leaves the state as it was (the
  frame is still rendered); the learner's update returns its parameters and
  optimizer state unchanged.
- `half_batch`: the sampler's tick steps the first half of the envs and
  leaves the rest as they were; the learner's loss is the mean over the
  first half of the envs only.
- `answer_altered`: the sampler's frames come out with their top quarter
  changed; the rollout's stored log-probabilities come out shifted.
- `exchange_left_out`: the data-parallel update skips the all-reduce, so
  each rank steps on its own gradients.
- `reset_skipped`: the tick's deferred reset copies nothing, so an env whose
  episode ends keeps its old layout (sampler and learner alike).
"""

from __future__ import annotations

from typing import Callable

import torch

FAULTS = ("state_unchanged", "half_batch", "answer_altered", "exchange_left_out",
          "reset_skipped")


def _patch(obj, name: str, new) -> Callable[[], None]:
    old = getattr(obj, name)
    setattr(obj, name, new)
    return lambda: setattr(obj, name, old)


def plant(fault: str, kind: str) -> Callable[[], None]:
    """Plant `fault` in the program's `kind` of entry ("sampler" or
    "appo"); returns the undo."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}: {FAULTS}")
    import megaverse_tpu_torch.capture as CAP
    from megaverse_tpu_torch.types import tree_copy_, tree_map

    real_tick = CAP.tick
    undo = []
    if fault == "reset_skipped":
        undo.append(_patch(CAP, "apply_deferred_resets", lambda state, *args, **kw: state))
    elif kind == "sampler" and fault == "state_unchanged":
        def tick(scenario, state, next_scenes, action, shaping, render=True, **kw):
            saved = tree_map(torch.clone, state)
            out = real_tick(scenario, state, next_scenes, action, shaping, render=render, **kw)
            tree_copy_(state, saved)
            return out
        undo.append(_patch(CAP, "tick", tick))
    elif kind == "sampler" and fault == "half_batch":
        def tick(scenario, state, next_scenes, action, shaping, render=True, **kw):
            half = state.done.shape[0] // 2
            saved = tree_map(lambda x: x[half:].clone(), state)
            out = real_tick(scenario, state, next_scenes, action, shaping, render=render, **kw)
            tree_map(lambda d, s: d[half:].copy_(s), state, saved)
            return out
        undo.append(_patch(CAP, "tick", tick))
    elif kind == "sampler" and fault == "answer_altered":
        def tick(*args, **kw):
            obs, *rest = real_tick(*args, **kw)
            if obs is not None:
                rows = obs.shape[-2] // 4
                obs[..., :rows, :] = obs[..., :rows, :] ^ 0x404040
            return (obs, *rest)
        undo.append(_patch(CAP, "tick", tick))
    elif kind == "appo":
        from megaverse_tpu_torch.parallel import mesh
        from megaverse_tpu_torch.rl import learner as L

        if fault == "state_unchanged":
            real = L.Learner._update_from_batch

            def update(self, ls, batch, pmean=None):
                _, metrics = real(self, ls, batch, pmean)
                return ls, metrics
            undo.append(_patch(L.Learner, "_update_from_batch", update))
        elif fault == "half_batch":
            real = L.Learner.loss_and_grads

            def loss_and_grads(self, params, batch, norm_adv, returns, progress=0.0):
                half = batch.reward.shape[1] // 2
                idx = torch.arange(half, device=batch.reward.device)
                return real(self, params, L.minibatch(batch, idx), norm_adv[:, :half],
                            returns[:, :half], progress)
            undo.append(_patch(L.Learner, "loss_and_grads", loss_and_grads))
        elif fault == "answer_altered":
            real = L.sample_actions

            def sample_actions(logits, generator):
                actions, logp = real(logits, generator)
                return actions, logp + 0.05
            undo.append(_patch(L, "sample_actions", sample_actions))
        elif fault == "exchange_left_out":
            undo.append(_patch(mesh.ParallelLearner, "pmean", lambda self, tree: dict(tree)))
        else:
            raise ValueError(fault)
    else:
        raise ValueError(f"fault {fault!r} has no {kind} form")

    def take_out():
        for u in reversed(undo):
            u()
    return take_out
