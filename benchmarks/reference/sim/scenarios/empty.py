"""Empty scenario (+ benchmark config).

ref: scenarios/src/scenario_empty.cpp: a single static floor box of
half-extents (10,1,10) at (5,0,5) colored BLUE, agents spawn at (1,1,1).
Counterpart of megaverse_tpu/scenarios/empty.py.
"""

from __future__ import annotations

import numpy as np

from reference.sim import constants as C
from reference.sim.scenarios import register_scenario
from reference.sim.scenarios.base import HostScene, Scenario
from reference.sim.types import GridConfig, SceneData
from reference.sim.utils.refrng import ref_spawn_yaw


class EmptyScenario(Scenario):
    name = "Empty"
    max_boxes = 8
    max_props = 1  # prop table must be non-empty for fixed shapes

    def grid_config(self) -> GridConfig:
        # Floor spans x,z in [-5, 15], y in [-1, 1] (scenario_empty.cpp:24-27).
        # Grid covers it plus jumping headroom.
        return GridConfig(dims=(24, 8, 24), voxel_size=1.0, origin=(-5.0, -2.0, -5.0))

    supports_ref_stream = True

    def _build(self, rng, yaws=None) -> SceneData:
        scene = HostScene(self.cfg)
        scene.add_static_box(scale=(10.0, 1.0, 10.0), translation=(5.0, 0.0, 5.0),
                             color=C.COLOR_IDX["BLUE"])
        positions = np.tile(np.array([1.0, 1.0, 1.0]), (self.num_agents, 1))
        scene.spawn_agents_at(positions, rng, yaws=yaws)
        return scene.finish(self.max_boxes)

    def generate(self, rng: np.random.Generator) -> SceneData:
        return self._build(rng)

    def generate_ref(self, rng) -> SceneData:
        # Reference draw order (Env::reset, env.cpp:57-76): the only draws in
        # an Empty episode are the per-agent spawn yaws
        # (DefaultScenario::spawnAgents, scenario_default.hpp:86).
        yaws = [ref_spawn_yaw(rng) for _ in range(self.num_agents)]
        return self._build(None, yaws=yaws)


register_scenario("Empty", EmptyScenario)
