"""The port's policy network (megaverse_tpu_torch.models.actor_critic) and the
flax weight converter (megaverse_tpu_torch.convert.actor_critic_*) held
against the JAX package's flax model on the CPU, at hidden 32, two GRU
layers, 72x128 observations, 2 envs x 2 agents.

Tolerances: float32 model 1e-5 (found: 4e-7); bfloat16 model 1e-2, the size
of one bf16 rounding step of a feature (2^-8 of values up to ~0.5) carried
through the float32 core and heads (found on an x86 CPU: 2e-7, the bf16
encoder output bit-equal); heads 1e-6, absolute and relative (a summed
log-probability reaches -22, where one float32 step is 1.9e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_checks  # noqa: F401  (one torch thread)
from megaverse_tpu.models import actor_critic as JM
from megaverse_tpu_torch import convert
from megaverse_tpu_torch.models import actor_critic as TM

HIDDEN = 32
B, A = 2, 2
UNIFORM_ENTROPY = float(np.log(3 ** 4 * 2 ** 2))   # Tuple(3,3,3,2,2,3)


@pytest.fixture(scope="module")
def flax_params():
    model = JM.ActorCritic(hidden_size=HIDDEN)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 72, 128, 3), jnp.uint8))
    return jax.tree.map(np.asarray, params)


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, 1 << 24, (B, A, 72, 128), dtype=np.int32)
    carry = rng.normal(0.0, 0.5, (B, A, 2 * HIDDEN)).astype(np.float32)
    return obs, carry


def port_model(params, dtype=torch.bfloat16):
    model = TM.ActorCritic(hidden_size=HIDDEN, dtype=dtype)
    model.load_state_dict(convert.actor_critic_from_flax(params))
    return model


def test_converter_round_trip_is_exact(flax_params):
    back = convert.actor_critic_to_flax(convert.actor_critic_from_flax(flax_params))
    torch_port_checks.assert_trees_equal(back, flax_params)


def test_converted_keys_and_shapes_are_the_models(flax_params):
    sd = convert.actor_critic_from_flax(flax_params)
    want = TM.ActorCritic(hidden_size=HIDDEN).state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        assert sd[k].shape == v.shape and sd[k].dtype == torch.float32, k
    # flax's dense kernel after the convolutions is [3 * 6 * 128, hidden]
    assert flax_params["params"]["encoder"]["Dense_0"]["kernel"].shape == (2304, HIDDEN)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_forward_matches_flax(flax_params, dtype, atol):
    obs, carry = inputs()
    jmodel = JM.ActorCritic(hidden_size=HIDDEN, dtype=getattr(jnp, dtype))
    jlogits, jvalue, jcarry = jax.jit(jmodel.apply)(flax_params, jnp.asarray(obs),
                                                    jnp.asarray(carry))
    model = port_model(flax_params, getattr(torch, dtype))
    with torch.no_grad():
        logits, value, new_carry = model(torch.from_numpy(obs), torch.from_numpy(carry))
    for got, want in zip(logits, jlogits):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)
    np.testing.assert_allclose(value.numpy(), np.asarray(jvalue), atol=atol, rtol=0)
    np.testing.assert_allclose(new_carry.numpy(), np.asarray(jcarry), atol=atol, rtol=0)
    # both GRU layers moved the carry
    assert np.abs(new_carry.numpy()[..., :HIDDEN] - carry[..., :HIDDEN]).max() > 1e-3
    assert np.abs(new_carry.numpy()[..., HIDDEN:] - carry[..., HIDDEN:]).max() > 1e-3


def test_uint8_and_packed_observations_agree(flax_params):
    obs, carry = inputs(1)
    rgb = np.stack([(obs >> 16) & 0xFF, (obs >> 8) & 0xFF, obs & 0xFF], -1).astype(np.uint8)
    model = port_model(flax_params)
    with torch.no_grad():
        a = model(torch.from_numpy(obs), torch.from_numpy(carry))
        b = model(torch.from_numpy(rgb), torch.from_numpy(carry))
    for x, y in zip(a[0] + (a[1], a[2]), b[0] + (b[1], b[2])):
        assert torch.equal(x, y)


def test_sequence_forward_equals_steps(flax_params):
    """The sequence form (encoder over all steps at once, the carry zeroed
    after done steps) equals the step form called once per step."""
    rng = np.random.default_rng(2)
    t_len = 3
    obs = torch.from_numpy(rng.integers(0, 1 << 24, (t_len, B, A, 72, 128), dtype=np.int32))
    done = torch.tensor([[False, True], [True, False], [False, True]])
    carry0 = torch.from_numpy(inputs(2)[1])
    model = port_model(flax_params, torch.float32)
    with torch.no_grad():
        logits, values, last = model(obs, carry0, done=done)
        carry = carry0
        for t in range(t_len):
            lg, v, carry = model(obs[t], carry)
            for h in range(len(lg)):
                torch.testing.assert_close(logits[h][t], lg[h], atol=1e-6, rtol=0)
            torch.testing.assert_close(values[t], v, atol=1e-6, rtol=0)
            carry = torch.where(done[t][:, None, None], 0.0, carry)
    torch.testing.assert_close(last, carry, atol=1e-6, rtol=0)
    assert bool((last[0] != 0).any()) and bool((last[1] == 0).all())


def test_heads_match_jax():
    rng = np.random.default_rng(3)
    logits = [rng.normal(0, 2.0, (5, 7, n)).astype(np.float32) for n in TM.ACTION_HEADS]
    actions = np.stack([rng.integers(0, n, (5, 7)) for n in TM.ACTION_HEADS], -1)
    jlp, jent = JM.action_log_prob_entropy([jnp.asarray(x) for x in logits],
                                           jnp.asarray(actions, jnp.int32))
    tlp, tent = TM.action_log_prob_entropy([torch.from_numpy(x) for x in logits],
                                           torch.from_numpy(actions))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tent.numpy(), np.asarray(jent), atol=1e-6, rtol=1e-6)
    jkl = JM.symmetric_kl_from_uniform([jnp.asarray(x) for x in logits])
    tkl = TM.symmetric_kl_from_uniform([torch.from_numpy(x) for x in logits])
    np.testing.assert_allclose(tkl.numpy(), np.asarray(jkl), atol=1e-6, rtol=1e-6)


def test_sample_actions_follows_the_policy():
    rng = np.random.default_rng(4)
    logits = [torch.from_numpy(np.broadcast_to(rng.normal(0, 1.0, n), (20000, n)).copy())
              .float() for n in TM.ACTION_HEADS]
    acts, logp = TM.sample_actions(logits, torch.Generator().manual_seed(0))
    again, _ = TM.sample_actions(logits, torch.Generator().manual_seed(0))
    assert acts.shape == (20000, 6) and torch.equal(acts, again)
    torch.testing.assert_close(logp, TM.action_log_prob_entropy(logits, acts)[0])
    for h, lg in enumerate(logits):
        freq = torch.bincount(acts[:, h], minlength=lg.shape[-1]).float() / acts.shape[0]
        torch.testing.assert_close(freq, torch.softmax(lg[0], -1), atol=0.015, rtol=0)


def test_fresh_model_starts_where_flax_does(flax_params):
    """flax's initializers: per-tensor spread like flax's (lecun normal),
    orthogonal recurrent kernels, zero biases; the fresh policy is close to
    uniform (as tests/test_learner.py::test_entropy_starts_uniform)."""
    model = TM.ActorCritic(hidden_size=HIDDEN, generator=torch.Generator().manual_seed(0))
    ref = convert.actor_critic_from_flax(flax_params)
    for k, v in model.state_dict().items():
        if k.endswith("bias"):
            assert not v.any(), k
        elif v.numel() >= 1024:
            assert abs(float(v.std()) / float(ref[k].std()) - 1) < 0.1, k
    for cell in model.core:
        for lin in (cell.hr, cell.hz, cell.hn):
            w = lin.weight.detach()
            torch.testing.assert_close(w @ w.T, torch.eye(HIDDEN), atol=1e-5, rtol=0)
    obs, carry = inputs(5)
    with torch.no_grad():
        logits, _, _ = model(torch.from_numpy(obs), torch.from_numpy(carry))
    ent = TM.action_log_prob_entropy(logits, torch.zeros(B, A, 6, dtype=torch.long))[1]
    assert abs(float(ent.mean()) - UNIFORM_ENTROPY) < 0.2
