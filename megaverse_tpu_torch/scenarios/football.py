"""Football scenario (counterpart of megaverse_tpu/scenarios/football.py;
experimental in the reference; no rewards).

ref: scenarios/src/scenario_football.cpp. A walled room (14-24 x 12-24) with a
dynamic ball (Bullet sphere, r=2 scaled 0.5 -> world radius 1, mass 1); agents
kick it with Interact within 1.8 m, applying a 70 N force with an upward bias
(step, cpp:143-164).

The ball is an IMPULSE-BASED rigid body (linear + angular velocity) against
the static voxel world, mirroring Bullet's sequential-impulse contact model
with the reference's constants (DynamicRigidBody ctor, cpp:27-100, plus the
Bullet defaults the reference never overrides): world gravity (0, -10, 0);
restitution 0 (the ball lands and rolls); combined sliding friction 0.25;
combined rolling friction 0.05; inertia 1.6, computed by Bullet on the
UNSCALED btSphereShape(2), so the ball spins up as if r=2 while contacting
at r=1. See the JAX package's module for the derivation of each constant.

Per contact (floor / ceiling / 4 axis walls, detected by voxel probes):
normal impulse kills the approach velocity (e=0) with positional projection,
a tangential friction impulse (clamped at mu * normal impulse, coupling
v and omega through the contact arm) drives the slide -> roll transition,
and rolling friction decays omega under the same impulse budget.

Every division by a constant is an IEEE division by a float32 tensor (on
CUDA, `tensor / python_scalar` multiplies by the rounded reciprocal), and
norms and cross products are written out in the JAX package's order of
operations, so the ball's state agrees with it to float32 rounding.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from megaverse_tpu_torch import constants as C
from megaverse_tpu_torch.ops import grid as G
from megaverse_tpu_torch.ops.raycast import _div
from megaverse_tpu_torch.scenarios import register_scenario
from megaverse_tpu_torch.scenarios.base import HostScene, Scenario
from megaverse_tpu_torch.types import EnvState, GridConfig, SceneData, Tree, device_const
from megaverse_tpu_torch.utils.refrng import ref_spawn_yaw

BALL_RADIUS = 1.0    # btSphereShape(2.0) scaled 0.5
BALL_MASS = 1.0
BALL_INERTIA = 1.6   # 0.4 * m * 2^2: computed on the UNSCALED shape (Bullet quirk)
GRAVITY = 10.0       # btDiscreteDynamicsWorld default (never overridden)
MU = 0.25            # combined sliding friction 0.5 * 0.5
MU_ROLL = 0.05       # combined rolling friction 0.1 * 0.5 + 0 * 0.5

# contact normals, in the order of the sequential-impulse pass: floor first
# (the dominant contact), then the four walls, then the (rare) ceiling
_NORMALS = ((0, 1, 0), (1, 0, 0), (-1, 0, 0), (0, 0, 1), (0, 0, -1), (0, -1, 0))


@dataclasses.dataclass
class FootballState(Tree):
    ball_pos: Any    # f32 [B,3]
    ball_vel: Any    # f32 [B,3]
    ball_omega: Any  # f32 [B,3] angular velocity (rad/s)
    ball_prop: Any   # i32 [B]


def _norm(v: torch.Tensor) -> torch.Tensor:
    """|v| over the last axis (size 2 or 3), summed in index order."""
    acc = v[..., 0] * v[..., 0]
    for i in range(1, v.shape[-1]):
        acc = acc + v[..., i] * v[..., i]
    return torch.sqrt(acc)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis, as jnp.cross writes it."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


class FootballScenario(Scenario):
    name = "Football"
    scen_cls = FootballState
    max_boxes = 16
    prop_segments = ((C.PROP_SPHERE, 1),)

    def grid_config(self) -> GridConfig:
        return GridConfig(dims=(24, 10, 24), voxel_size=1.0, origin=(0.0, 0.0, 0.0))

    def _reward_shaping(self) -> Dict[str, float]:
        return {}

    def generate(self, rng: np.random.Generator) -> SceneData:
        rr = lambda lo, hi: int(rng.integers(lo, hi))
        length = rr(14, 24)
        width = rr(12, 24)
        height = rr(3, 7)
        positions = self._spawn_points(length, width, rr)
        yaws = [rng.random() * 2 * np.pi for _ in range(self.num_agents)]
        return self._build(length, width, height, positions, yaws)

    supports_ref_stream = True

    def generate_ref(self, rng) -> SceneData:
        """Reference draw order (FootballLayout::init, scenario_football.cpp:
        16-22: length/width/height; Platform::agentSpawnPoints occupancy
        sampling, platforms.hpp:221-244; then spawnAgents yaws)."""
        length = rng.rand_range(14, 24)
        width = rng.rand_range(12, 24)
        height = rng.rand_range(3, 7)
        positions = self._spawn_points(length, width, rng.rand_range)
        yaws = [ref_spawn_yaw(rng) for _ in range(self.num_agents)]
        return self._build(length, width, height, positions, yaws)

    def _spawn_points(self, length, width, rr):
        # Platform::agentSpawnPoints (platforms.hpp:221-244): <=10 attempts
        # per agent; retries on used cells consume draws.
        used, occupancy, positions = set(), {}, []
        for _ in range(self.num_agents):
            for _att in range(10):
                x = rr(1, length - 1)
                z = rr(1, width - 1)
                if (x, z) in used:
                    continue
                y = occupancy.get((x, z), 0) + 1
                occupancy[(x, z)] = occupancy.get((x, z), 0) + 2
                positions.append([x, y, z])
                used.add((x, z))
                break
        while len(positions) < self.num_agents:
            positions.append(positions[0])
        return positions

    def _build(self, length, width, height, positions, yaws) -> SceneData:
        scene = HostScene(self.cfg)
        white = C.COLOR_IDX["WHITE"]

        scene.vtype[0:length, 0, 0:width] |= C.VOXEL_SOLID | C.VOXEL_OPAQUE
        scene.vcolor[0:length, 0, 0:width] = white
        for (xs, zs) in ((np.s_[0:1], np.s_[0:width]), (np.s_[length - 1:length], np.s_[0:width]),
                         (np.s_[0:length], np.s_[0:1]), (np.s_[0:length], np.s_[width - 1:width])):
            scene.vtype[xs, 0:height, zs] |= C.VOXEL_SOLID | C.VOXEL_OPAQUE
            scene.vcolor[xs, 0:height, zs] = white

        ball_pos = np.array([5.0, 5.0, 5.0], np.float32)
        prop = scene.add_prop(C.PROP_SPHERE, ball_pos, (0.5, 0.5, 0.5),
                              C.COLOR_IDX["ORANGE"])

        scene.spawn_agents_at(np.asarray(positions, np.float64), None,
                              yaws=np.asarray(yaws, np.float32))

        scen = FootballState(
            ball_pos=ball_pos,
            ball_vel=np.zeros(3, np.float32),
            ball_omega=np.zeros(3, np.float32),
            ball_prop=np.int32(prop),
        )
        return scene.finish(self.max_boxes, scen=scen)

    def scen_step(self, state: EnvState, action: torch.Tensor, shaping: torch.Tensor):
        cfg = self.cfg.grid
        dt = self.cfg.dt
        f32 = torch.float32
        sc: FootballState = state.scen
        dev = sc.ball_pos.device
        vec = lambda v: device_const(v, f32, dev)
        ball = sc.ball_pos                                              # [B,3]

        # kicks (cpp:143-164): force 70 N for one tick on a 1 kg ball
        t = state.agents.pos + vec([0.0, C.AGENT_BODY_OFFSET_Y, 0.0])   # [B,A,3]
        delta = ball[:, None, :] - t
        dist = _norm(delta)                                              # [B,A]
        kick = ((action & C.ACTION_INTERACT) != 0) & (dist < 1.8)
        dir_ = delta / torch.clamp(dist[..., None], min=1e-6)
        dir_ = torch.stack([dir_[..., 0], torch.full_like(dir_[..., 1], 0.5),
                            dir_[..., 2]], dim=-1)
        impulse = torch.where(kick[..., None], 70.0 * dir_ * dt,
                              torch.zeros_like(dir_)).sum(dim=1)
        vel = sc.ball_vel + impulse

        # agent contacts: the reference ball is a Bullet dynamic body, so a
        # kinematic agent walking into it pushes it out of penetration
        # (capsule r=0.33 vs sphere r=1). Horizontal-only resolution, summed
        # over contacting agents.
        body = state.agents.pos + vec([0.0, C.AGENT_HALF_HEIGHT, 0.0])
        dxz = ball[:, None, 0::2] - body[..., 0::2]                     # [B,A,2]
        dh = _norm(dxz)
        overlap_v = (ball[:, None, 1] - body[..., 1]).abs() < (
            C.AGENT_HALF_HEIGHT + BALL_RADIUS)
        pen = (BALL_RADIUS + C.AGENT_CAPSULE_RADIUS) - dh
        touching = (pen > 0.0) & overlap_v
        push_dir = dxz / torch.clamp(dh[..., None], min=1e-6)
        push = torch.where(touching[..., None], push_dir * pen[..., None],
                           torch.zeros_like(push_dir)).sum(dim=1)       # [B,2]
        zero = torch.zeros_like(push[:, 0])
        pos0 = ball + torch.stack([push[:, 0], zero, push[:, 1]], dim=-1)
        # impart momentum: depenetration velocity, capped at walk speed
        push_v = torch.clamp(_div(push, dt), -C.KCC_MAX_HORIZONTAL_SPEED,
                             C.KCC_MAX_HORIZONTAL_SPEED)
        vel = vel + torch.stack([push_v[:, 0], zero, push_v[:, 1]], dim=-1)

        # --- impulse-based rigid-body integration vs the static voxel world ---
        omega = sc.ball_omega
        vel = vel - vec([0.0, GRAVITY * dt, 0.0])
        pos = pos0 + vel * dt

        def contact(pos, vel, omega, n_tuple):
            """Resolve one axis-aligned contact with normal n (unit, toward
            the ball). Sequential impulse: normal (e=0) + positional
            projection, then friction (couples v and omega through the
            contact arm), then rolling friction under the same budget."""
            axis = int(np.argmax(np.abs(n_tuple)))
            sign = float(n_tuple[axis])
            n = vec(n_tuple)
            # probe the voxel just past the contact point
            probe = G.world_to_voxel(cfg, pos - n * (BALL_RADIUS + 1e-3))    # [B,3]
            hit = G.solid_from_cols(cfg, state.cols, probe)                 # [B]
            plane = (probe[:, axis] + (sign > 0)).to(f32) \
                * cfg.voxel_size + cfg.origin[axis]
            # pen > 0 means overlap along n (s>0: plane+R-pos; s<0: pos-plane+R)
            pen = sign * (plane - pos[:, axis]) + BALL_RADIUS
            hit = hit & (pen > -1e-3)

            # n is axis-aligned with entries 0 / +-1: the dot products are
            # exact whatever the order of the sum
            v_n = (vel * n).sum(dim=-1)
            zero = torch.zeros_like(v_n)
            j_n = torch.where(hit, torch.clamp(-v_n, min=0.0) * BALL_MASS, zero)
            # resting-contact budget: the normal impulse that cancels this
            # tick's gravity (Bullet's solver produces it every step)
            j_rest = BALL_MASS * GRAVITY * dt * n[1].abs()
            j_budget = j_n + torch.where(hit, j_rest, zero)
            vel = vel + n * _div(j_n, BALL_MASS)[:, None]
            # positional projection out of penetration
            pos = pos + n * torch.where(hit, torch.clamp(pen, min=0.0), zero)[:, None]

            # friction at the contact point: r_c = -n * R (center -> contact)
            r_c = -n * BALL_RADIUS
            v_cp = vel + _cross(omega, r_c.expand_as(omega))
            v_t = v_cp - n * (v_cp * n).sum(dim=-1, keepdim=True)
            sp = _norm(v_t)
            t_hat = v_t / torch.clamp(sp, min=1e-9)[:, None]
            # effective mass along the tangent (sphere: arm perp to tangent)
            k = 1.0 / BALL_MASS + BALL_RADIUS * BALL_RADIUS / BALL_INERTIA
            j_t = torch.minimum(_div(sp, k), MU * j_budget)
            j_t = torch.where(hit & (sp > 1e-6), j_t, zero)
            vel = vel - t_hat * _div(j_t, BALL_MASS)[:, None]
            omega = omega - _div(_cross(r_c.expand_as(t_hat), t_hat * j_t[:, None]),
                                 BALL_INERTIA)

            # rolling friction: torque impulse <= mu_roll * j_n against omega
            w = _norm(omega)
            dw = torch.where(hit, torch.minimum(
                w, _div(MU_ROLL * j_budget * BALL_RADIUS, BALL_INERTIA)), zero)
            omega = omega - omega / torch.clamp(w, min=1e-9)[:, None] * dw[:, None]
            return pos, vel, omega

        for n in _NORMALS:
            pos, vel, omega = contact(pos, vel, omega, n)

        ball_prop = sc.ball_prop.long()[:, None]
        prop_pos = state.props.pos.clone()
        prop_pos[G._bidx(ball_prop), ball_prop] = pos[:, None, :]
        sc = sc.replace(ball_pos=pos, ball_vel=vel, ball_omega=omega)
        state = state.replace(props=state.props.replace(pos=prop_pos), scen=sc,
                              true_objective=torch.zeros_like(state.true_objective))
        return state, torch.zeros_like(state.last_reward)


register_scenario("Football", FootballScenario)
