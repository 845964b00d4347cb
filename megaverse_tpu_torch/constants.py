"""Global constants for megaverse_tpu_torch (a copy of megaverse_tpu/constants.py).

Numerical constants mirror the reference engine (alex-petrenko/megaverse) so that
gameplay semantics match; citations point into the reference tree:

- action bit flags:          src/libs/env/include/env/env.hpp:22-42
- action space factorization src/libs/env/src/env.cpp:33
- color palette:             src/libs/env/include/env/const.hpp:25-143
- camera parameters:         src/libs/env/include/env/env_renderer.hpp:34-38
- character controller:      src/libs/env/include/env/kinematic_character_controller.hpp:155-177
- agent geometry:            src/libs/env/src/agent.cpp:25-65, agent.hpp:109-110
"""

import numpy as np

# ---------------------------------------------------------------------------
# Action model (bitmask, same bit layout as the reference enum).
# ---------------------------------------------------------------------------
ACTION_IDLE = 0
ACTION_LEFT = 1 << 1
ACTION_RIGHT = 1 << 2
ACTION_FORWARD = 1 << 3
ACTION_BACKWARD = 1 << 4
ACTION_LOOK_LEFT = 1 << 5
ACTION_LOOK_RIGHT = 1 << 6
ACTION_JUMP = 1 << 7
ACTION_INTERACT = 1 << 8
ACTION_LOOK_DOWN = 1 << 9
ACTION_LOOK_UP = 1 << 10
NUM_ACTIONS = 11

# Tuple-of-Discrete factorization: (move_x, move_z, look_yaw, jump, interact, look_pitch)
# ref: env.cpp:33 `actionSpaceSizes = {3, 3, 3, 2, 2, 3}` and the multi-discrete ->
# bitmask decoding in bindings/megaverse.cpp:100-117.
ACTION_SPACE_SIZES = (3, 3, 3, 2, 2, 3)

# Per-head bit lookup: head h with choice c contributes ACTION_HEAD_BITS[h][c].
ACTION_HEAD_BITS = (
    (0, ACTION_LEFT, ACTION_RIGHT),
    (0, ACTION_FORWARD, ACTION_BACKWARD),
    (0, ACTION_LOOK_LEFT, ACTION_LOOK_RIGHT),
    (0, ACTION_JUMP),
    (0, ACTION_INTERACT),
    (0, ACTION_LOOK_DOWN, ACTION_LOOK_UP),
)

# ---------------------------------------------------------------------------
# Simulation timing (ref: env.hpp:160).
# ---------------------------------------------------------------------------
DEFAULT_FRAME_RATE = 15.0
DEFAULT_DT = 1.0 / DEFAULT_FRAME_RATE

# ---------------------------------------------------------------------------
# Kinematic character controller (ref: kinematic_character_controller.hpp:155-177
# and agent.cpp:52-64, 157-161).
# ---------------------------------------------------------------------------
KCC_GRAVITY = 1.4 * 9.8                # m/s^2, ref kcc.hpp:169
KCC_FALL_SPEED = 55.0                  # terminal velocity, ref kcc.cpp:135
KCC_JUMP_SPEED = 6.2                   # jump impulse, ref agent.cpp:160
KCC_MAX_HORIZONTAL_SPEED = 4.5         # ref kcc.hpp:173
KCC_MAX_AIR_SPEED = 1.0                # ref kcc.hpp:174
KCC_NORMAL_DECELERATION = 15.0         # ground friction, ref kcc.hpp:175
KCC_MAX_ACCELERATION = 35.0 + KCC_NORMAL_DECELERATION  # = 50, ref kcc.hpp:176
KCC_MAX_AIR_ACCELERATION = 3.0         # ref kcc.hpp:176
KCC_OVERSPEED_DECELERATION = KCC_MAX_ACCELERATION * 2  # ref kcc.hpp:177
KCC_STEP_HEIGHT = 0.2                  # ref agent.cpp:59
KCC_MAX_SLOPE_RAD = np.deg2rad(45.0)   # ref kcc.cpp:146
KCC_EPSILON = 1.19209290e-07           # SIMD_EPSILON (FLT_EPSILON)

AGENT_CAPSULE_RADIUS = 0.33            # ref agent.cpp:53
AGENT_CAPSULE_HEIGHT = 1.05            # cylinder section height, ref agent.cpp:52
AGENT_HALF_HEIGHT = (AGENT_CAPSULE_HEIGHT + 2 * AGENT_CAPSULE_RADIUS) / 2  # 0.855
AGENT_HEIGHT = 1.75                    # spawn offset, ref agent.hpp:110
AGENT_ROTATE_RADIANS = 3.5             # yaw speed rad/s, ref agent.hpp:109
AGENT_ROTATE_X_RADIANS = 1.5           # pitch speed rad/s, ref agent.hpp:109
AGENT_LOOK_DOWN_FACTOR = 1.1           # looking down is faster, ref agent.cpp:123
AGENT_BODY_OFFSET_Y = 0.05             # visual offset, ref agent.cpp:95
AGENT_CAMERA_OFFSET_Y = 0.41           # camera child offset, ref agent.cpp:33
AGENT_PICKUP_SPOT = (0.0, -0.44, -1.0)  # interact anchor (camera-local), ref agent.cpp:40
CARRYING_SCALE = 0.78                  # a carried object's scale, ref component_object_stacking.hpp:63

# ---------------------------------------------------------------------------
# Camera (ref: env_renderer.hpp:34-38 — fov 100 deg, near 0.01, far 120,
# aspect 128/72; fov is the horizontal field of view in Magnum convention).
# ---------------------------------------------------------------------------
CAMERA_FOV_DEG = 100.0
CAMERA_NEAR = 0.01
CAMERA_FAR = 120.0
OBS_WIDTH = 128
OBS_HEIGHT = 72

# ---------------------------------------------------------------------------
# Voxel state bit flags (ref: env/voxel_state.hpp:10-17).
# ---------------------------------------------------------------------------
VOXEL_EMPTY = 0
VOXEL_SOLID = 1
VOXEL_OPAQUE = 2

# Terrain bit flags (ref: scenarios/platforms.hpp:28-34).
TERRAIN_NONE = 0
TERRAIN_EXIT = 1
TERRAIN_LAVA = 2
TERRAIN_BUILDING_ZONE = 4

# ---------------------------------------------------------------------------
# Drawable (prop) types (ref: env.hpp:58-69).
# ---------------------------------------------------------------------------
PROP_NONE = -1
PROP_BOX = 0
PROP_CAPSULE = 1
PROP_SPHERE = 2
PROP_CONE = 3
PROP_CYLINDER = 4
PROP_ROTBOX = 5  # y-rotated box (maze landmarks); not a reference drawable type
# Hex maze wall + its bottom edging strip fused into ONE primitive (the
# edging geometry is fully derived from the wall's: length x1.02, height
# fraction 0.12, half-depth 0.2 — scenarios/hex.py build_maze). One table row
# ships both boxes and the renderer shares the rotated-ray math between them.
PROP_ROTBOX_WALL = 6
# Fused hex wall + bottom edging (PROP_ROTBOX_WALL). INVARIANT: a
# PROP_ROTBOX_WALL's center-y must equal its y half-extent (the wall stands
# on the floor, spanning y in [0, 2*hy]) — the renderer derives the edging
# box from the wall's extents pinning the edging bottom to world y=0, and
# build_clusters sizes the cluster AABB from the wall half-height alone
# (asserted in scenarios/base.py add_prop).
WALL_EDGE_LEN_SCALE = 1.02   # edging half-length = wall half-length * this
WALL_EDGE_H_FRAC = 0.12      # edging half-height = wall half-height * this
WALL_EDGE_HZ = 0.2           # edging half-depth (wall's is 0.15)

# ---------------------------------------------------------------------------
# Color palette (ref: const.hpp:25-143). Index into PALETTE is the canonical
# on-device color id; 0 is reserved for "unset".
# ---------------------------------------------------------------------------
_COLOR_HEX = {
    "YELLOW": 0xFFDD3C,
    "GREEN": 0x3BB372,
    "LIGHT_GREEN": 0x50C878,
    "BLUE": 0x2EB5D0,
    "LIGHT_BLUE": 0xADD8E6,
    "DARK_BLUE": 0x3A7FA6,
    "DARK_NAVY": 0x2C3E50,
    "ORANGE": 0xFFB400,
    "GREY": 0xB3B3B3,
    "DARK_GREY": 0x555555,
    "VERY_DARK_GREY": 0x222222,
    "WHITE": 0xFFFFFF,
    "RED": 0xFF0000,
    "LIGHT_ORANGE": 0xFFA770,
    "VIOLET": 0xD468EE,
    "LIGHT_PINK": 0xFFE6E6,
    "VERY_LIGHT_YELLOW": 0xFFFFE6,
    "VERY_LIGHT_GREEN": 0xCCFFCC,
    "VERY_LIGHT_BLUE": 0xE6ECFF,
    "VERY_LIGHT_GREY": 0xD9D9D9,
    "VERY_LIGHT_VIOLET": 0xF2E6FF,
    "VERY_LIGHT_ORANGE": 0xFFEBCC,
}

COLOR_NAMES = ["NONE"] + list(_COLOR_HEX.keys())
COLOR_IDX = {name: i for i, name in enumerate(COLOR_NAMES)}

# Aliases (ref: const.hpp:51-56).
COLOR_IDX["LAYOUT_DEFAULT"] = COLOR_IDX["WHITE"]
COLOR_IDX["AGENT_EYES"] = COLOR_IDX["DARK_NAVY"]
COLOR_IDX["MOVABLE_BOX"] = COLOR_IDX["LIGHT_BLUE"]
COLOR_IDX["EXIT_PAD"] = COLOR_IDX["LIGHT_GREEN"]
COLOR_IDX["BUILDING_ZONE"] = COLOR_IDX["DARK_GREY"]


def _hex_to_rgb(h: int) -> np.ndarray:
    return np.array([(h >> 16) & 0xFF, (h >> 8) & 0xFF, h & 0xFF], dtype=np.float32) / 255.0


# PALETTE[i] = linear-ish RGB in [0, 1]; index 0 is black/unset.
PALETTE = np.stack([np.zeros(3, np.float32)] + [_hex_to_rgb(h) for h in _COLOR_HEX.values()])
NUM_COLORS = len(COLOR_NAMES) - 1  # 22, matches ref numColors

# Random color pools (ref: const.hpp:58-143); stored as palette indices.
ALL_COLORS = np.array([COLOR_IDX[n] for n in _COLOR_HEX.keys()], dtype=np.int32)

AGENT_COLORS = np.array(
    [COLOR_IDX[n] for n in
     ("YELLOW", "GREEN", "BLUE", "ORANGE", "VIOLET", "VERY_DARK_GREY", "RED")],
    dtype=np.int32,
)

OBJECT_COLORS = np.array(
    [COLOR_IDX[n] for n in
     ("YELLOW", "GREEN", "LIGHT_GREEN", "BLUE", "LIGHT_BLUE", "DARK_BLUE", "ORANGE",
      "GREY", "DARK_GREY", "WHITE", "RED", "LIGHT_ORANGE", "VIOLET", "LIGHT_PINK")],
    dtype=np.int32,
)

LAYOUT_COLORS = np.array(
    [COLOR_IDX[n] for n in
     ("WHITE", "VERY_LIGHT_YELLOW", "VERY_LIGHT_GREEN", "VERY_LIGHT_BLUE",
      "VERY_LIGHT_GREY", "VERY_LIGHT_ORANGE", "GREY", "GREY", "GREY", "GREY",
      "DARK_GREY", "DARK_GREY", "DARK_GREY", "DARK_GREY")],
    dtype=np.int32,
)

# Terrain overlay colors (ref: platforms.hpp terrainColor usage in layout_utils.cpp:53-68).
TERRAIN_COLOR_IDX = {
    TERRAIN_EXIT: COLOR_IDX["EXIT_PAD"],
    TERRAIN_LAVA: COLOR_IDX["RED"],
    TERRAIN_BUILDING_ZONE: COLOR_IDX["BUILDING_ZONE"],
}

# ---------------------------------------------------------------------------
# Lighting (ref: v4r_env_renderer.cpp:219-221 — light at (0, 4, 2), intensity
# 0.66 grey; magnum_env_renderer.cpp:201 — shininess 300, color 0xaaaaaa).
# ---------------------------------------------------------------------------
LIGHT_POSITION = (0.0, 4.0, 2.0)
LIGHT_COLOR = (0.6667, 0.6667, 0.6667)
LIGHT_SHININESS = 300.0

# Sky / clear color for rays that miss everything.
SKY_COLOR = (0.1333, 0.1333, 0.1333)  # 0x222222-ish dark background

# FloatParams keys (ref: env/const.hpp:12-19).
P_EPISODE_LENGTH_SEC = "episodeLengthSec"
P_VERTICAL_LOOK_LIMIT = "verticalLookLimitRad"
P_USE_UI_REWARD_INDICATORS = "useUIRewardIndicators"
P_TEAM_SPIRIT = "teamSpirit"
