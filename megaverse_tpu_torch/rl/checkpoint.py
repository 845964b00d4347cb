"""Training checkpoints, readable by both packages.

A checkpoint is a pickle of {"params": the policy's parameters in flax's
layout as numpy (`convert.actor_critic_to_flax`), "opt_state": the optimizer
state, "steps": env steps trained}. The port writes its own Adam state as
numpy there (`learner.opt_state_to_numpy`); the JAX package's
megaverse_tpu/rl/train.py writes optax's state classes, so a plain
`pickle.load` of its file would import optax and JAX. `load_checkpoint`
reads such files without them: every class of jax, jaxlib, flax, optax or
chex in the file becomes an inert stand-in, and only `params` is meant to be
read from them.
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path
from typing import Any, Dict

from megaverse_tpu_torch.convert import actor_critic_to_flax
from megaverse_tpu_torch.rl.learner import Params, opt_state_to_numpy

_FOREIGN = ("jax", "jaxlib", "flax", "optax", "chex")


class Inert(tuple):
    """Stand-in for a class of the JAX stack found in a checkpoint: keeps the
    constructor's positional arguments as a tuple and runs nothing."""

    def __new__(cls, *args, **kwargs):
        return tuple.__new__(cls, args)

    def __setstate__(self, state):
        pass


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in _FOREIGN:
            # flax's FrozenDict pickles as FrozenDict(plain dict)
            return dict if name == "FrozenDict" else Inert
        return super().find_class(module, name)


def load_checkpoint(path) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return _CheckpointUnpickler(f).load()


def is_port_opt_state(opt_state) -> bool:
    """Whether a checkpoint's optimizer state is the port's own (a dict of
    count, mu, nu) rather than optax's."""
    return isinstance(opt_state, dict) and set(opt_state) == {"count", "mu", "nu"}


def save_checkpoint(path, params: Params, opt_state: Dict[str, Any], steps: int) -> None:
    """Write the checkpoint through a temporary file, so that a run cut
    while writing leaves the previous checkpoint whole."""
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump({"params": actor_critic_to_flax(params),
                     "opt_state": opt_state_to_numpy(opt_state),
                     "steps": int(steps)}, f)
    os.replace(tmp, path)
