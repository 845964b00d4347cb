"""The free camera (`env.render_custom_camera`) of the port against the JAX
package's, on the CPU.

One Empty layout (2 agents) becomes a JAX state, converted to the port's
(`convert.state_from_numpy`); both packages render it from the same outside camera at a size that is no
multiple of the kernel's 8 x 128 tiles (48 x 80): at most 1 per colour
channel on fewer than 1e-4 of the pixels, outside the pixels where the
port's own float32 is ill-conditioned (the same expressions in float64 give
another colour), as tests/test_torch_pvs.py::test_b1_matches_jax_image
holds the first-person image. On the card the port's image comes from the
render kernel's form B1, held against this plain version by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import megaverse_tpu.constants as C
from megaverse_tpu.env import render_custom_camera as j_render_custom_camera
from megaverse_tpu.scenarios import make_scenario as j_make_scenario
from megaverse_tpu.types import state_from_scene as j_state_from_scene

from megaverse_tpu_torch import convert
from megaverse_tpu_torch.env import custom_camera_tables, render_custom_camera
from megaverse_tpu_torch.ops import raycast as TR
from megaverse_tpu_torch.ops import raycast_cuda as TRC
from megaverse_tpu_torch.scenarios import make_scenario as t_make_scenario
from megaverse_tpu_torch.types import scene_to_device, stack_scenes, state_from_scene

import torch_port_checks as K  # noqa: F401  (one torch thread)

H, W = 48, 80


def _unpack(p):
    return np.stack([(p >> 16) & 0xFF, (p >> 8) & 0xFF, p & 0xFF], -1).astype(np.int64)


@pytest.fixture(scope="module")
def states():
    """(JAX scenario, unbatched JAX state, port scenario, port state [B=1])
    of one Empty layout with 2 agents; the port's state is the JAX one,
    converted."""
    jsc = j_make_scenario("Empty", num_agents=2)
    tsc = t_make_scenario("Empty", num_agents=2)
    jscene = jsc.generate_checked(np.random.default_rng(5))
    jstate = j_state_from_scene(jax.tree.map(jnp.asarray, jscene), 2, jax.random.PRNGKey(0))
    tstate = convert.state_from_numpy(
        convert.to_numpy_tree(jax.tree.map(lambda x: np.asarray(x)[None], jstate)))
    np.testing.assert_array_equal(np.asarray(jstate.agents.pos), tstate.agents.pos[0].numpy())
    np.testing.assert_array_equal(np.asarray(jstate.box_lo), tstate.box_lo[0].numpy())
    return jsc, jstate, tsc, tstate


def _outside_camera(tstate):
    """Eye 2 m above and 4 m behind agent 0, looking down at it."""
    pos = tstate.agents.pos[0, 0].numpy().astype(np.float64)
    return pos + np.array([0.0, 2.0, 4.0]), 0.0, -0.45


def test_matches_jax_image(states):
    jsc, jstate, tsc, tstate = states
    eye, yaw, pitch = _outside_camera(tstate)
    got = render_custom_camera(tsc, tstate, eye, yaw, pitch, width=W, height=H)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (H, W, 3)
    assert got.device == tstate.box_lo.device
    want = np.asarray(jax.jit(
        lambda s, e: j_render_custom_camera(jsc, s, e, yaw, pitch, width=W, height=H)
    )(jstate, jnp.asarray(eye, jnp.float32)))
    got = got.numpy().astype(np.int64)
    assert len(np.unique(got.reshape(-1, 3), axis=0)) > 8, "the image is (nearly) constant"
    delta = np.abs(got - want.astype(np.int64))
    tabs = custom_camera_tables(tsc, tstate, eye, yaw, pitch, width=W, height=H)
    img64 = TR.render_table_packed(tabs["cams"].double(), tabs["prims"].double(), H, W,
                                   False).numpy()
    sensitive = (got != _unpack(img64)[0, 0]).any(-1)
    assert sensitive.sum() <= 16
    assert (delta[sensitive] <= 8).all(), f"set-aside pixels: max delta {delta[sensitive].max()}"
    assert (delta[~sensitive] <= 1).all(), f"max channel delta {delta[~sensitive].max()}"
    assert (delta[~sensitive] != 0).any(-1).mean() < 1e-4


def test_tables_keep_agent_rows_and_default_size(states):
    _, _, tsc, tstate = states
    eye, yaw, pitch = _outside_camera(tstate)
    tabs = custom_camera_tables(tsc, tstate, eye, yaw, pitch)
    assert (tabs["height"], tabs["width"]) == (2 * C.OBS_HEIGHT, 2 * C.OBS_WIDTH)
    kinds = set(tabs["prims"][0, :, 0].tolist())
    assert TRC.PRIM_EYEBOX in kinds, "the agents' eye rows are dropped"
    cams = tabs["cams"][0, 0]
    np.testing.assert_allclose(cams[:3].numpy(), np.asarray(eye, np.float32), atol=1e-6)
    assert cams[3].item() == yaw and cams[4].item() == np.float32(pitch)
    assert cams[5].item() == 1.0 and cams[6].item() == 0.0
    img = render_custom_camera(tsc, tstate, eye, yaw, pitch)
    assert tuple(img.shape) == (2 * C.OBS_HEIGHT, 2 * C.OBS_WIDTH, 3)


def test_overview_camera_shows_agent_body():
    """Mirror of tests/test_render.py::test_overview_camera_shows_agent_body:
    an outside viewpoint looking at the agent sees body pixels."""
    tsc = t_make_scenario("Empty", num_agents=1)
    scene = tsc.generate_checked(np.random.default_rng(7))
    st = state_from_scene(scene_to_device(stack_scenes([scene]), "cpu"), 1,
                          torch.zeros((1,), dtype=torch.int64))
    pos = st.agents.pos[0, 0].numpy()
    eye = pos + np.asarray([0.0, 2.0, 4.0])
    img = render_custom_camera(tsc, st, eye, yaw=0.0, pitch=-0.45, width=128, height=72).numpy()
    assert img.shape == (72, 128, 3)
    agent_rgb = (np.asarray(C.PALETTE[C.AGENT_COLORS[0]]) * 255).astype(int)
    close = (np.abs(img.astype(int) - agent_rgb).sum(-1) < 180)
    assert close.any(), "agent body not visible from overview camera"
