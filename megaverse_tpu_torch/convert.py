"""State and weights carried across the two packages.

Layouts and states are what a caller moves between the JAX package and this
port on the step path. These functions turn `SceneData` / `EnvState` given as
numpy (field by field: a dict of arrays, with nested dicts for `props`,
`agents` and `scen`) into the port's dataclasses and back; and the policy's
flax parameter tree (as numpy) into the port's `ActorCritic` state_dict and
back (`actor_critic_from_flax`, `actor_critic_to_flax`). They take numpy only, so the port imports nothing of the JAX package; a
caller holding JAX objects flattens them with `to_numpy_tree` (duck-typed on
dataclass-like objects) first.

Differences bridged here:
  * the JAX package keeps one unbatched state per env and adds the batch with
    vmap; arrays passed in must already carry the leading env axis B (a
    vmapped/stacked JAX state does);
  * packed solid columns are uint32 there and int32 (same bits) here;
  * `EnvState.rng` is a PRNG key there and an int64 counter here (no device
    code draws from either): it is not converted, the caller supplies one.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Mapping, Optional, Type

import numpy as np
import torch

from megaverse_tpu_torch.types import AgentState, EnvState, PropState, SceneData

_SCENE_LEAVES = ("cols", "vterrain", "vobj", "box_lo", "box_hi", "box_color",
                 "agent_spawn", "agent_yaw", "episode_len_sec")
_STATE_LEAVES = ("cols", "vterrain", "vobj", "box_lo", "box_hi", "box_color",
                 "done", "num_frames", "episode_sec", "episode_len_sec",
                 "last_reward", "total_reward", "true_objective")


def to_numpy_tree(obj) -> Any:
    """Flatten a dataclass-like object (anything with `__dataclass_fields__`)
    of array-likes into nested dicts of numpy arrays. Empty tuples / None
    (scenarios without extra state) become None."""
    if obj is None or (isinstance(obj, tuple) and not obj):
        return None
    if hasattr(obj, "__dataclass_fields__"):
        return {name: to_numpy_tree(getattr(obj, name))
                for name in obj.__dataclass_fields__}
    if isinstance(obj, torch.Tensor):
        # a copy: tensors of a live state change in place at every tick
        # (`.cpu()` of a CUDA tensor is one already)
        x = obj.detach().cpu().numpy()
        return x.copy() if obj.device.type == "cpu" else x
    return np.asarray(obj)


def _tensor(x, device) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(x))
    if arr.dtype == np.uint32:      # packed solid columns
        arr = arr.view(np.int32)
    return torch.from_numpy(arr.copy()).to(device)


def _sub(cls: Type, tree: Dict[str, Any], device):
    return cls(**{f.name: _tensor(tree[f.name], device)
                  for f in dataclasses.fields(cls)})


def _scen(scen_cls: Optional[Type], tree, device):
    if scen_cls is None or tree is None:
        return None
    return _sub(scen_cls, tree, device)


def scen_class(scenario_name: str) -> Optional[Type]:
    """The port's scenario-state dataclass for a registered scenario name
    (TowerState, CollectState, ObstaclesState, SokobanState, ...; None for
    scenarios that carry no extra state): the `scen_cls` the converters below take."""
    from megaverse_tpu_torch.scenarios import make_scenario

    return make_scenario(scenario_name).scen_cls


def scene_from_numpy(tree: Dict[str, Any], scen_cls: Optional[Type] = None,
                     device="cpu") -> SceneData:
    """Nested dict of batched numpy arrays (SceneData fields) -> SceneData of
    tensors. `scen_cls` is the port's scenario-state dataclass (e.g.
    scenarios.tower_building.TowerState) or None."""
    return SceneData(
        **{k: _tensor(tree[k], device) for k in _SCENE_LEAVES},
        props=_sub(PropState, tree["props"], device),
        scen=_scen(scen_cls, tree.get("scen"), device))


def state_from_numpy(tree: Dict[str, Any], scen_cls: Optional[Type] = None,
                     device="cpu", rng: Optional[torch.Tensor] = None) -> EnvState:
    """Nested dict of batched numpy arrays (EnvState fields) -> EnvState of
    tensors. The `rng` entry of the dict, if any, is ignored (see module
    docstring); pass the port's int64 [B] counter or get zeros."""
    bsz = np.asarray(tree["done"]).shape[0]
    if rng is None:
        rng = torch.zeros((bsz,), dtype=torch.int64, device=device)
    return EnvState(
        **{k: _tensor(tree[k], device) for k in _STATE_LEAVES},
        props=_sub(PropState, tree["props"], device),
        agents=_sub(AgentState, tree["agents"], device),
        rng=rng,
        scen=_scen(scen_cls, tree.get("scen"), device))


def _unsign_cols(tree: Dict[str, Any]) -> None:
    """View every packed-column leaf of a nested dict as uint32, in place.
    Packed solid columns are named `cols` or `*_cols` in both packages
    (EnvState.cols, SceneData.cols, BoxAGoneState.base_cols)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _unsign_cols(v)
        elif k == "cols" or k.endswith("_cols"):
            tree[k] = v.view(np.uint32)


def tree_to_numpy(obj, unsigned_cols: bool = True) -> Any:
    """The port's SceneData / EnvState (or any of their sub-trees) -> nested
    dicts of numpy arrays in the JAX package's dtypes: every packed-column
    leaf, at any depth, goes back to uint32."""
    tree = to_numpy_tree(obj)
    if unsigned_cols and isinstance(tree, dict):
        _unsign_cols(tree)
    return tree


def render_inputs_to_numpy(tables: Dict[str, Any]) -> Dict[str, Any]:
    """cams / prims / cull tables (env.render_tables) as numpy, unchanged in
    layout: both packages use the same row formats."""
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in tables.items()}


def render_inputs_from_numpy(tables: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    return {k: (torch.from_numpy(np.ascontiguousarray(v)).to(device)
                if isinstance(v, np.ndarray) else v)
            for k, v in tables.items()}


# ---------------------------------------------------------------------------
# Policy weights: flax's ActorCritic parameter tree <-> the port's state_dict.
# ---------------------------------------------------------------------------

# (port module path, flax module path) patterns; the parameter name maps
# weight <-> kernel and bias <-> bias
_MODULE_PATHS = (
    (r"encoder\.convs\.(\d+)", r"encoder/Conv_\1"),
    (r"encoder\.dense", r"encoder/Dense_0"),
    (r"core\.(\d+)\.(ir|iz|hr|hz|hn)", r"core_\1/\2"),
    (r"core\.(\d+)\.in_", r"core_\1/in"),
    (r"action_heads\.(\d+)", r"action_heads_\1"),
    (r"value_head", r"value_head"),
)
_FLAX_MODULE_PATHS = (
    (r"encoder/Conv_(\d+)", r"encoder.convs.\1"),
    (r"encoder/Dense_0", r"encoder.dense"),
    (r"core_(\d+)/(ir|iz|hr|hz|hn)", r"core.\1.\2"),
    (r"core_(\d+)/in", r"core.\1.in_"),
    (r"action_heads_(\d+)", r"action_heads.\1"),
    (r"value_head", r"value_head"),
)


def _map_path(path: str, table) -> str:
    for pat, repl in table:
        if re.fullmatch(pat, path):
            return re.sub(pat, repl, path)
    raise KeyError(f"no counterpart for parameter module {path!r}")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def actor_critic_from_flax(params) -> Dict[str, torch.Tensor]:
    """The JAX package's ActorCritic parameters ({'params': {...}} or the
    inner tree, numpy or array-like leaves) -> a state_dict of the port's
    `models.actor_critic.ActorCritic`. Dense kernels [in, out] become
    weights [out, in]; conv kernels HWIO become OIHW. The dense layer after
    the convolutions keeps flax's (h, w, c) row order: the port flattens its
    activations in that order."""
    tree = params.get("params", params)
    sd = {}
    for path, leaf in _flatten(tree):
        arr = np.asarray(leaf, dtype=np.float32)
        module = _map_path("/".join(path[:-1]), _FLAX_MODULE_PATHS)
        if path[-1] == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            sd[module + ".weight"] = torch.tensor(np.ascontiguousarray(arr))
        elif path[-1] == "bias":
            sd[module + ".bias"] = torch.tensor(arr)
        else:
            raise KeyError(f"unknown flax parameter {'/'.join(path)!r}")
    return sd


def actor_critic_to_flax(state_dict) -> Dict[str, Any]:
    """Inverse of `actor_critic_from_flax`: a state_dict (tensors on any
    device) -> {'params': {...}} of float32 numpy arrays in flax's layout,
    which the JAX package's `ActorCritic.apply` takes."""
    out: Dict[str, Any] = {}
    for key, t in state_dict.items():
        module, _, name = key.rpartition(".")
        arr = t.detach().to("cpu", torch.float32).numpy()
        if name == "weight":
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
            leaf = "kernel"
        elif name == "bias":
            leaf = "bias"
        else:
            raise KeyError(f"unknown parameter {key!r}")
        node = out
        for part in _map_path(module, _MODULE_PATHS).split("/"):
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(arr)
    return {"params": out}
