"""The character controller's kernel wrapper (ops/kcc.py), kernel rules only.

The kernel (csrc/kcc.cu) runs only on the card, where chip_smoke.py holds it
bit for bit against its plain version. Here: on the CPU `physics_step` is
the plain pair, player_step then resolve_agent_collisions, and loads no
library; the wrapper refuses what the kernel does not take; the launch
counter has the kernel; the source exports what the wrapper binds, and its
constant table matches the wrapper's field for field. No JAX: the plain pair
is held against the JAX package by tests/test_torch_physics.py.
"""

import inspect
import re

import numpy as np
import pytest
import torch

import megaverse_tpu_torch.constants as C
from megaverse_tpu_torch.ops import grid as G
from megaverse_tpu_torch.ops import kcc as K
from megaverse_tpu_torch.ops import physics as P
from megaverse_tpu_torch.ops import raycast_cuda as RC
from megaverse_tpu_torch.types import AgentState, GridConfig

import torch_port_checks  # noqa: F401  (one intra-op torch thread)

CFG = GridConfig(dims=(12, 40, 12), voxel_size=1.0, origin=(0.0, -1.0, 0.0))
DT = C.DEFAULT_DT
B = 3


def world(seed: int) -> torch.Tensor:
    """Packed columns [B, X, 2, Z]: a floor, pillars and a step."""
    rng = np.random.default_rng(seed)
    v = np.zeros((B,) + CFG.dims, np.uint8)
    v[:, :, 0:2, :] = C.VOXEL_SOLID
    v[:, 8, 2, :] = C.VOXEL_SOLID
    for b in range(B):
        for x, z in rng.integers(2, 10, size=(5, 2)):
            v[b, x, 2:5, z] = C.VOXEL_SOLID
    return G.pack_solid_columns(CFG, torch.from_numpy(v))


def agents(seed: int, num_agents: int) -> AgentState:
    """Agents crowded around (6, 6) near the floor, moving in all directions."""
    rng = np.random.default_rng(seed)
    shape = (B, num_agents)
    pos = np.stack([6 + rng.uniform(-1.5, 1.5, shape), 1.9 + rng.uniform(0, 0.5, shape),
                    6 + rng.uniform(-1.5, 1.5, shape)], -1)
    hvel = np.stack([rng.uniform(-4, 4, shape), np.zeros(shape),
                     rng.uniform(-4, 4, shape)], -1)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    return AgentState.create(B, num_agents).replace(
        pos=f32(pos), hvel=f32(hvel), vvel=f32(rng.uniform(-3, 3, shape)),
        jumping=torch.from_numpy(rng.random(shape) < 0.3),
        on_ground=torch.from_numpy(rng.random(shape) < 0.5))


def walls(seed: int) -> torch.Tensor:
    """[B, 4, 7] rotated walls through the crowd, the last row inert."""
    rng = np.random.default_rng(seed)
    w = np.zeros((B, 4, 7), np.float32)
    w[:, :, 0] = 6 + rng.uniform(-1, 1, (B, 4))
    w[:, :, 1] = 1.0 + 0.7
    w[:, :, 2] = 6 + rng.uniform(-1, 1, (B, 4))
    w[:, :, 3] = rng.uniform(0.5, 1.5, (B, 4))
    w[:, :, 4] = 0.7
    w[:, :, 5] = 0.15
    w[:, :, 6] = rng.uniform(-np.pi, np.pi, (B, 4))
    w[:, 3, 4] = -1.0
    return torch.from_numpy(w)


@pytest.mark.parametrize("num_agents", [1, 4])
def test_physics_step_on_the_cpu_is_the_plain_pair(monkeypatch, num_agents):
    def refuse():
        raise AssertionError("the KCC library was loaded for a CPU tick")

    monkeypatch.setattr(K, "load_library", refuse)
    cols, a = world(num_agents), agents(num_agents, num_agents)
    results = {}
    for name, obbs in (("grid", None), ("walls", walls(num_agents))):
        launches = dict(RC.LAUNCHES)
        got = K.physics_step(CFG, a, DT, cols, obbs)
        assert RC.LAUNCHES == launches
        stepped = P.player_step(CFG, a, DT, cols=cols, obbs=obbs)
        want = P.resolve_agent_collisions(stepped, CFG, cols=cols, obbs=obbs)
        for k in ("pos", "yaw", "pitch", "vvel", "hvel", "jumping", "on_ground", "carried"):
            assert torch.equal(getattr(got, k), getattr(want, k)), (name, k)
        if num_agents > 1:    # the pairwise push took part
            assert not torch.equal(want.pos, stepped.pos), name
        results[name] = want.pos
    assert not torch.equal(results["grid"], results["walls"])   # the walls took part


def _bad_inputs(case: str):
    cols, a, obbs = world(0), agents(0, 2), walls(0)
    if case == "dtype":
        return a.replace(vvel=a.vvel.double()), cols, obbs, "vvel"
    if case == "shape":
        return a, cols[:, :, :1], obbs, "cols"
    if case == "device":
        return a.replace(hvel=a.hvel.to("meta")), cols, obbs, "hvel"
    return a, cols, obbs.transpose(0, 1).contiguous().transpose(0, 1), "obbs"


@pytest.mark.parametrize("case", ["dtype", "shape", "device", "non_contiguous"])
def test_kcc_step_refuses_what_the_kernel_does_not_take(case):
    a, cols, obbs, name = _bad_inputs(case)
    launches = dict(RC.LAUNCHES)
    with pytest.raises(ValueError, match=name):
        K.kcc_step(CFG, a, DT, cols, obbs)
    if case == "device":    # right in every other way, but not on the card
        with pytest.raises(ValueError, match="CUDA"):
            K.kcc_step(CFG, agents(0, 2), DT, world(0), walls(0))
    assert RC.LAUNCHES == launches


def test_launch_counter_has_the_kernel():
    assert "kcc" in RC.LAUNCHES and "kcc" not in RC.FORMS
    saved = dict(RC.LAUNCHES)
    try:
        RC.LAUNCHES["kcc"] = 5
        RC.reset_launch_counts()
        assert RC.LAUNCHES["kcc"] == 0
    finally:
        RC.LAUNCHES.update(saved)


def test_source_exports_the_bound_symbols_and_constants():
    source = (RC.CSRC_DIR / "kcc.cu").read_text()
    exported = source[source.index('extern "C" {'):]
    names = set(re.findall(r"^int (mv_\w+)\(", exported, flags=re.M))
    bound = set(re.findall(r"\blib\.(mv_\w+)", inspect.getsource(K.load_library)))
    assert bound and bound == names
    # the Consts struct, field for field and type for type
    body = source[source.index("struct Consts {"):]
    body = re.sub(r"//[^\n]*", "", body[:body.index("};")])
    fields = [(name, ctype) for ctype, group in re.findall(r"\b(int|float) ([\w, ]+);", body)
              for name in re.split(r",\s*", group)]
    kind = {ctypes_t: c for c, ctypes_t in (("int", "c_int"), ("float", "c_float"))}
    assert fields == [(n, kind[t.__name__]) for n, t in K.Consts._fields_]
