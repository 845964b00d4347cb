"""The port's data-parallel scale-out (megaverse_tpu_torch.parallel) on the
CPU, with two gloo ranks in spawned processes (they import no JAX; they
meet at a `file://` store under the test's tmp_path, never a fixed port).

- Sharded `VectorEnv` sampling (Collect 4 envs x 1 agent, 24 px, reset + 3
  steps): the two ranks' frames, rewards and dones, joined in rank order,
  equal one process's bit for bit (the reference's contract,
  __graft_entry__.py:121-133).
- One data-parallel `_update_from_batch` on a fixed batch (the synthetic
  batch of tests/test_torch_learner.py: 2 envs, one per rank): both
  replicas' parameters are bit-equal, and equal the JAX package's
  `_update_from_batch(..., axis_name="data")` under `shard_map` on a 2-device
  mesh of conftest's virtual CPU devices within 1e-5, from the same
  converted parameters (advantages normalised per shard in both).
- `rl.train --device cpu --n_devices 2` runs one update of Empty 4 x 1 at
  hidden 32 and writes one checkpoint.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from megaverse_tpu.parallel.mesh import shard_map
import megaverse_tpu.constants as C
from megaverse_tpu.rl import learner as JL

from megaverse_tpu_torch import convert, entry
from megaverse_tpu_torch.parallel import ParallelLearner, rank_seed, spawn, world
from megaverse_tpu_torch.rl import train
from megaverse_tpu_torch.rl.checkpoint import load_checkpoint

import torch_parallel_ranks
from test_torch_learner import CFG, STEP, flat_items, jax_learner, synthetic_batch
import torch_port_checks  # noqa: F401  (one torch thread)


@pytest.fixture
def one_thread(monkeypatch):
    """The spawned ranks inherit this: one intra-op thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_sharded_sampling_equals_one_process(tmp_path, one_thread):
    case = dict(label="collect", name="Collect", num_envs=4, num_agents=1, seed=7, steps=3,
                obs_height=24)
    outputs = entry.run_ranks(dict(devices=["cpu", "cpu"], sampling=[case]))
    single = entry.sample(case, "cpu")
    assert single["obs"].shape == (4, 4, 1, 24, 128, 3)
    for o in outputs:
        assert o["collect"]["obs"].shape[1] == 2
    for key in ("obs", "reward", "done"):
        assert torch.equal(entry.gathered(outputs, "collect", key), single[key]), key
    # the shards hold different envs
    assert not torch.equal(outputs[0]["collect"]["obs"], outputs[1]["collect"]["obs"])


def _jax_sharded_update(params, d):
    """The JAX package's update with gradients pmean'ed over a 2-device mesh
    (conftest's virtual CPU devices), the batch sharded on its env axis."""
    jl = jax_learner()
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    env_axis = P(None, "data")
    bspec = JL.RolloutBatch(*([env_axis] * 6), P("data"))

    def step(params, opt_state, obs, carry, batch):
        ls = JL.LearnerState(params, opt_state, None, obs, carry, jax.random.PRNGKey(1),
                             jnp.asarray(STEP, jnp.int32))
        ls2, metrics = jl._update_from_batch(ls, batch, axis_name="data")
        return ls2.params, metrics

    kwargs = dict(mesh=mesh, in_specs=(P(), P(), P("data"), P("data"), bspec),
                  out_specs=(P(), P()))
    try:
        fn = shard_map(step, check_vma=False, **kwargs)
    except TypeError:  # older jax
        fn = shard_map(step, check_rep=False, **kwargs)
    batch = JL.RolloutBatch(*(jnp.asarray(d[k]) for k in (
        "obs", "actions", "logp", "value", "reward", "done", "init_carry")))
    out = jax.jit(fn)(params, jl.tx.init(params), jnp.asarray(d["last_obs"]),
                      jnp.asarray(d["last_carry"]), batch)
    return jax.tree.map(np.asarray, out)


def test_sharded_update_matches_jax_shard_map(tmp_path, one_thread):
    params, d = synthetic_batch()
    tparams = convert.actor_critic_from_flax(params)
    t = lambda k: torch.from_numpy(np.asarray(d[k]))
    inputs = dict(cfg=CFG, agents=2, num_envs=2, step=STEP, params=tparams,
                  last_obs=t("last_obs"), last_carry=t("last_carry"),
                  batch={k: (t(k).long() if k == "actions" else t(k)) for k in (
                      "obs", "actions", "logp", "value", "reward", "done", "init_carry")})
    path = tmp_path / "inputs.pt"
    torch.save(inputs, path)
    spawn(torch_parallel_ranks.update_rank, 2, f"file://{tmp_path / 'init'}",
          args=(str(path), str(tmp_path)))
    ranks = [torch.load(tmp_path / f"update{r}.pt") for r in range(2)]
    assert [r["envs"] for r in ranks] == [1, 1]
    assert not any(r["jax_imported"] for r in ranks)
    for k, v in ranks[0]["params"].items():
        assert torch.equal(v, ranks[1]["params"][k]), k
    for k, v in ranks[0]["metrics"].items():
        assert torch.equal(v, ranks[1]["metrics"][k]), k

    want_params, want_metrics = _jax_sharded_update(params, d)
    got = dict(flat_items(convert.actor_critic_to_flax(ranks[0]["params"])))
    moved = 0.0
    for path_, want in flat_items(want_params):
        np.testing.assert_allclose(got[path_], want, atol=1e-5, rtol=0, err_msg=path_)
    for path_, before in flat_items(params):
        moved = max(moved, float(np.abs(got[path_] - before).max()))
    assert moved > 5e-5
    for k in ("loss", "policy_loss", "value_loss", "entropy", "reward_mean"):
        np.testing.assert_allclose(float(ranks[0]["metrics"][k]), want_metrics[k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_train_cli_two_ranks_writes_one_checkpoint(tmp_path, one_thread):
    argv = ["--env", "Empty", "--num_envs", "4", "--num_agents_per_env", "1",
            "--rollout", "2", "--hidden_size", "32", "--train_for_env_steps", "8",
            "--device", "cpu", "--n_devices", "2", "--train_dir", str(tmp_path)]
    assert train.main(argv) == 0
    out = tmp_path / "default"
    summary = json.loads((out / "train_summary.json").read_text())
    assert summary["updates"] == 1 and summary["n_devices"] == 2
    assert summary["env_steps"] == 8 and summary["num_envs"] == 4
    assert np.isfinite(summary["metrics"]["loss"])
    ckpt = load_checkpoint(out / "checkpoint.pkl")
    assert ckpt["steps"] == 8
    assert sorted(p.name for p in out.iterdir()) == ["checkpoint.pkl", "train_summary.json"]


def test_parallel_rules_without_a_group(monkeypatch):
    """No process group: one rank of one; ParallelLearner refuses to run;
    more ranks than CUDA devices raise; the ranks' generator seeds differ."""
    assert world() == (0, 1)
    with pytest.raises(RuntimeError):
        ParallelLearner(object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="only 1 CUDA devices"):
        train.main(["--env", "Empty", "--num_envs", "4", "--n_devices", "2"])
    with pytest.raises(ValueError):
        train.main(["--env", "Empty", "--num_envs", "3", "--n_devices", "2",
                    "--device", "cpu"])
    assert len({rank_seed(42, r) for r in range(8)}) == 8
    assert rank_seed(42, 0) == rank_seed(42, 0) != rank_seed(43, 0)


@pytest.mark.parametrize("local_rank", [None, "1"])
def test_launched_rank_without_a_card_raises(monkeypatch, local_rank):
    """A rank (its LOCAL_RANK when a launcher sets it) past the last card
    raises instead of sharing a card; the ranks that have one get their own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    with pytest.raises(RuntimeError, match="no card of its own"):
        train.resolve_device("cuda", rank=1, world_size=2)
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert train.resolve_device("cuda", rank=0, world_size=2) == torch.device("cuda", 0)


def test_vector_env_shard_seeds_by_global_index():
    from megaverse_tpu_torch import VectorEnv

    full = VectorEnv("Empty", num_envs=4, device="cpu", render=False)
    part = VectorEnv("Empty", num_envs=4, device="cpu", render=False, shard=(1, 2))
    assert (part.num_envs, part.global_num_envs, part.env_offset) == (2, 4, 2)
    full.reset()
    part.reset()
    assert torch.equal(part.state.rng, full.state.rng[2:])
    assert torch.equal(part.state.agents.pos, full.state.agents.pos[2:])
    with pytest.raises(ValueError):
        VectorEnv("Empty", num_envs=3, device="cpu", shard=(0, 2))
    full.close()
    part.close()


def test_entry_forward_and_dryrun_multichip(one_thread):
    """The twin of __graft_entry__.py: the flagship policy's forward on 16
    frames, and dryrun_multichip(2) on the CPU (its own checks raise)."""
    forward, (params, obs, carry) = entry.entry(device="cpu")
    logits, value, new_carry = forward(params, obs, carry)
    assert [tuple(lg.shape) for lg in logits] == [(16, n) for n in C.ACTION_SPACE_SIZES]
    assert tuple(value.shape) == (16,) and new_carry.shape == carry.shape
    report = entry.dryrun_multichip(2, device="cpu")
    assert set(report["sampling"]) == {"collect", "hexmemory"}
    assert report["train"]["replicas_equal"] and report["train"]["envs"] == [1, 1]
