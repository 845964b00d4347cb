"""The port's learner (megaverse_tpu_torch.rl.learner) and its CLIs
(rl.train, rl.enjoy) on the CPU.

The learner's numbers are held against the JAX package's `Learner` on one
synthetic rollout (hidden 32, two GRU layers, 72x128 observations, T=4,
2 envs x 2 agents, float32 model, done rows, a clipped ratio, a clipped
gradient and a linear lr schedule), with the JAX side run in one jitted
program (no env step compiles): GAE advantages and returns to float32
rounding (1e-6), the loss and its metrics to 1e-5 relative, the gradients
(through the converter) to 1e-5 relative to each tensor's largest entry, the
parameters after one update to 1e-5. Minibatching, the rollout and the CLIs
are held inside the port.
"""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_checks  # noqa: F401  (one torch thread)
import megaverse_tpu.constants as C
from megaverse_tpu.models.actor_critic import ActorCritic as JActorCritic
from megaverse_tpu.rl import learner as JL
from megaverse_tpu.scenarios import make_scenario as j_make_scenario
from megaverse_tpu_torch import convert
from megaverse_tpu_torch.env import env_step, render_batch
from megaverse_tpu_torch.models.actor_critic import action_log_prob_entropy
from megaverse_tpu_torch.rl import enjoy, learner as TL, train
from megaverse_tpu_torch.scenarios import make_scenario as t_make_scenario
from megaverse_tpu_torch.types import (multidiscrete_to_bitmask, stack_scenes,
                                       scene_to_device, state_from_scene, tree_map)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, B, A, HIDDEN = 4, 2, 2, 32
STEP = 32          # env steps trained before this update (sets the progress)
CFG = dict(rollout=T, hidden_size=HIDDEN, max_grad_norm=0.05, lr_final=1e-5,
           total_env_steps=64.0, exploration_final=0.01)


def synthetic_batch():
    """numpy inputs of one update: params from PRNGKey(0), packed obs, a
    behaviour logp that is the current policy's plus noise (so the ratio
    clip is active), done rows, rewards of both signs."""
    rng = np.random.default_rng(3)
    jmodel = JActorCritic(hidden_size=HIDDEN, dtype=jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 72, 128, 3), jnp.uint8))
    d = dict(
        obs=rng.integers(0, 1 << 24, (T, B, A, 72, 128), dtype=np.int32),
        actions=np.stack([rng.integers(0, n, (T, B, A)) for n in C.ACTION_SPACE_SIZES],
                         -1).astype(np.int32),
        value=rng.normal(0, 0.5, (T, B, A)).astype(np.float32),
        reward=rng.normal(0, 1.0, (T, B, A)).astype(np.float32),
        done=np.array([[False, False], [True, False], [False, False], [False, True]]),
        init_carry=rng.normal(0, 0.5, (B, A, 2 * HIDDEN)).astype(np.float32),
        last_obs=rng.integers(0, 1 << 24, (B, A, 72, 128), dtype=np.int32),
        last_carry=rng.normal(0, 0.5, (B, A, 2 * HIDDEN)).astype(np.float32))
    jl = jax_learner()
    batch = JL.RolloutBatch(jnp.asarray(d["obs"]), jnp.asarray(d["actions"]),
                            jnp.zeros((T, B, A)), jnp.zeros((T, B, A)), jnp.zeros((T, B, A)),
                            jnp.asarray(d["done"]), jnp.asarray(d["init_carry"]))
    logits, _ = jax.jit(jl._forward_sequence)(params, batch)
    from megaverse_tpu.models.actor_critic import action_log_prob_entropy as j_logp
    lp = np.asarray(j_logp(logits, jnp.asarray(d["actions"]))[0])
    d["logp"] = (lp + rng.normal(0, 0.3, lp.shape)).astype(np.float32)
    return jax.tree.map(np.asarray, params), d


def jax_learner():
    jl = JL.Learner(j_make_scenario("Empty", num_agents=A), B, JL.TrainConfig(**CFG))
    jl.model = JActorCritic(hidden_size=HIDDEN, dtype=jnp.float32)
    return jl


def port_learner(**over):
    cfg = TL.TrainConfig(**dict(CFG, model_dtype=torch.float32, **over))
    return TL.Learner(t_make_scenario("Empty", num_agents=A), B, cfg, device="cpu")


def port_batch(d):
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    return TL.RolloutBatch(t["obs"], t["actions"].long(), t["logp"], t["value"], t["reward"],
                           t["done"], t["init_carry"])


def port_state(params_np, d, seed=0):
    params = convert.actor_critic_from_flax(params_np)
    return TL.LearnerState(params, TL.adam_init(params), None, torch.from_numpy(d["last_obs"]),
                           torch.from_numpy(d["last_carry"]),
                           torch.Generator().manual_seed(seed), STEP)


@pytest.fixture(scope="module")
def reference():
    """Everything the JAX learner computes on the synthetic batch, in one
    jitted program: GAE, loss, metrics and gradients at the update's
    progress, and the parameters and metrics after `_update_from_batch`."""
    params, d = synthetic_batch()
    jl = jax_learner()
    batch = JL.RolloutBatch(*(jnp.asarray(d[k]) for k in
                              ("obs", "actions", "logp", "value", "reward", "done",
                               "init_carry")))
    ls = JL.LearnerState(params, jl.tx.init(params), None, jnp.asarray(d["last_obs"]),
                         jnp.asarray(d["last_carry"]), jax.random.PRNGKey(1),
                         jnp.asarray(STEP, jnp.int32))

    def run(ls, batch):
        _, last_value, _ = jl._policy(ls.params, ls.obs, ls.carry)
        adv, ret = jl._gae(batch, last_value)
        progress = ls.step.astype(jnp.float32) / CFG["total_env_steps"]
        (loss, metrics), grads = jax.value_and_grad(jl._loss, has_aux=True)(
            ls.params, batch, adv, ret, progress)
        ls2, metrics2 = jl._update_from_batch(ls, batch)
        return dict(adv=adv, ret=ret, loss=loss, metrics=metrics, grads=grads,
                    params=ls2.params, metrics_after=metrics2)

    out = jax.tree.map(np.asarray, jax.jit(run)(ls, batch))
    return params, d, out


def port_gae(params, d):
    tl = port_learner()
    ls = port_state(params, d)
    with torch.no_grad():
        _, last_value, _ = tl._policy(ls.params, ls.obs, ls.carry)
    return tl, ls, tl._gae(port_batch(d), last_value)


def test_gae_matches_jax(reference):
    params, d, ref = reference
    _, _, (adv, ret) = port_gae(params, d)
    np.testing.assert_allclose(adv.numpy(), ref["adv"], atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(ret.numpy(), ref["ret"], atol=1e-6, rtol=1e-6)
    # the normalisation is by the population std
    raw = ret.numpy() - d["value"]
    np.testing.assert_allclose(adv.numpy(), (raw - raw.mean()) / (raw.std() + 1e-8),
                               atol=1e-5, rtol=0)


def test_loss_and_gradients_match_jax(reference):
    params, d, ref = reference
    tl, ls, (adv, ret) = port_gae(params, d)
    loss, metrics, grads = tl.loss_and_grads(ls.params, port_batch(d), adv, ret,
                                             STEP / CFG["total_env_steps"])
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-5, atol=1e-7, err_msg=k)
    flat = dict(flat_items(convert.actor_critic_to_flax(grads)))
    for path, want in flat_items(ref["grads"]):
        scale = np.abs(want).max()
        assert scale > 0, path
        np.testing.assert_allclose(flat[path], want, atol=1e-5 * scale, rtol=0, err_msg=path)


def flat_items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat_items(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


def test_update_matches_jax(reference):
    """One `_update_from_batch` with the gradient clip active (global norm
    above max_grad_norm) and the linear lr schedule: parameters after."""
    params, d, ref = reference
    gnorm = np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                        for _, g in flat_items(ref["grads"])))
    assert gnorm > CFG["max_grad_norm"]
    tl = port_learner()
    ls, metrics = tl._update_from_batch(port_state(params, d), port_batch(d))
    assert ls.opt_state["count"] == 1
    got = dict(flat_items(convert.actor_critic_to_flax(ls.params)))
    moved = 0.0
    for path, want in flat_items(ref["params"]):
        np.testing.assert_allclose(got[path], want, atol=1e-5, rtol=0, err_msg=path)
    for path, before in flat_items(params):
        moved = max(moved, float(np.abs(got[path] - before).max()))
    assert moved > 5e-5      # lr 1e-4 at count 0
    np.testing.assert_allclose(float(metrics["loss"]), ref["metrics_after"]["loss"], rtol=1e-5)


def test_schedule_clip_and_adam_match_optax():
    import optax

    for count in (0, 1, 7, 12, 40):
        np.testing.assert_equal(TL.linear_schedule(1e-3, 1e-5, 12, count),
                                np.float32(optax.linear_schedule(1e-3, 1e-5, 12)(count)))
    rng = np.random.default_rng(9)
    grads = {"a": rng.normal(size=(3, 4)).astype(np.float32),
             "b": rng.normal(size=(5,)).astype(np.float32)}
    params = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in grads.items()}
    for max_norm in (0.5, 100.0):        # clipped, untouched
        tx = optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(1e-2))
        state = tx.init(params)
        tstate = TL.adam_init({k: torch.from_numpy(v) for k, v in params.items()})
        p, tp = params, {k: torch.from_numpy(v) for k, v in params.items()}
        for step in range(3):
            g = {k: v * (step + 1) for k, v in grads.items()}
            upd, state = tx.update(g, state, p)
            p = optax.apply_updates(p, upd)
            tg = TL.clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()},
                                        max_norm)
            tp, tstate = TL.adam_update(tg, tstate, tp, 1e-2)
        for k in p:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(p[k]), atol=1e-6, rtol=0)


def test_minibatches_equal_sequential_updates(reference):
    """num_epochs=2, num_minibatches=2: the update equals single-batch
    updates on the env rows of the same permutations, in turn (the same
    learner: its lr schedule counts the minibatch updates)."""
    params, d, _ = reference
    tl = port_learner(num_epochs=2, num_minibatches=2)
    got, _ = tl._update_from_batch(port_state(params, d, seed=5), port_batch(d))

    ls = port_state(params, d, seed=5)
    batch = port_batch(d)
    with torch.no_grad():
        _, last_value, _ = tl._policy(ls.params, ls.obs, ls.carry)
    adv, ret = tl._gae(batch, last_value)
    p, opt = ls.params, ls.opt_state
    gen = torch.Generator().manual_seed(5)
    for _ in range(2):
        perm = torch.randperm(B, generator=gen)
        for m in range(2):
            idx = perm[m:m + 1]
            p, opt, _ = tl._apply(p, opt, TL.minibatch(batch, idx), adv[:, idx],
                                  ret[:, idx], STEP / CFG["total_env_steps"])
    assert opt["count"] == got.opt_state["count"] == 4
    for k in p:
        assert torch.equal(p[k], got.params[k]), k


def empty_start(num_envs=2, seed=0, episode_sec=0.1):
    """An Empty batch (2 agents, episodes of 2 ticks) at its first frame."""
    scen = t_make_scenario("Empty", num_agents=A, params={C.P_EPISODE_LENGTH_SEC: episode_sec})
    gens = [np.random.default_rng(seed + i) for i in range(num_envs)]
    first = scene_to_device(stack_scenes([scen.generate_checked(g) for g in gens]), "cpu")
    nxt = scene_to_device(stack_scenes([scen.generate_checked(g) for g in gens]), "cpu")
    state = state_from_scene(first, A, torch.arange(num_envs, dtype=torch.int64))
    obs = render_batch(scen, state, fmt="packed")
    shaping = torch.from_numpy(np.tile(scen.shaping_array()[None], (num_envs, 1, 1)))
    return scen, state, obs, nxt, shaping


def test_rollout_replays_through_the_env():
    """collect_rollout on Empty (2 envs x 2 agents, 72x128, rollout 4, done
    every second tick): replaying its actions through env_step +
    render_batch gives the same observations, rewards and dones; the stored
    logp is the sequence forward's; the carry is zero after a done row."""
    scen, state, obs, nxt, shaping = empty_start()
    cfg = TL.TrainConfig(rollout=T, hidden_size=HIDDEN)
    tl = TL.Learner(scen, B, cfg, device="cpu")
    ls = tl.init(0, state, obs)
    ls2, batch = tl.collect_rollout(ls, nxt, shaping)
    assert batch.obs.shape == (T, B, A, 72, 128) and batch.obs.dtype == torch.int32
    assert bool(batch.done.any()) and bool(batch.done[-1].all())
    assert ls2.step == T * B and not ls2.carry.any()
    st, o = state, obs
    for t in range(T):
        assert torch.equal(batch.obs[t], o), t
        res = env_step(scen, st, nxt, multidiscrete_to_bitmask(batch.actions[t]), shaping)
        torch.testing.assert_close(batch.reward[t], res.reward.clamp(-30, 30), rtol=0, atol=0)
        assert torch.equal(batch.done[t], res.done)
        st, o = res.state, render_batch(scen, res.state, fmt="packed")
    assert torch.equal(ls2.obs, o)
    for a, b in zip(tree_leaves_of(ls2.env_state), tree_leaves_of(st)):
        assert torch.equal(a, b)
    with torch.no_grad():
        logits, values = tl._forward_sequence(ls.params, batch)
    torch.testing.assert_close(action_log_prob_entropy(logits, batch.actions)[0], batch.logp,
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(values, batch.value, atol=1e-5, rtol=0)


def tree_leaves_of(tree):
    out = []
    tree_map(lambda x: out.append(x), tree)
    return out


def test_fresh_learner_entropy_starts_uniform():
    scen, state, obs, nxt, shaping = empty_start(episode_sec=60.0)
    tl = TL.Learner(scen, B, TL.TrainConfig(rollout=2, hidden_size=HIDDEN), device="cpu")
    ls, metrics = tl.train_step(tl.init(0, state, obs), nxt, shaping)
    # uniform over Tuple(3,3,3,2,2,3): ln(3^4 * 2^2) = 5.783
    assert abs(float(metrics["entropy"]) - 5.783) < 0.2
    assert np.isfinite(float(metrics["loss"]))


TRAIN_ARGS = ["--env", "Empty", "--num_envs", "2", "--num_agents_per_env", "2",
              "--rollout", "2", "--hidden_size", "32", "--device", "cpu"]


def test_train_cli_checkpoints_and_resumes(tmp_path, capsys):
    args = TRAIN_ARGS + ["--train_dir", str(tmp_path), "--train_for_env_steps", "8"]
    assert train.main(args) == 0
    out_dir = tmp_path / "default"
    first = pickle.loads((out_dir / "checkpoint.pkl").read_bytes())
    assert first["steps"] == 8 and first["opt_state"]["count"] == 2
    summary = (out_dir / "train_summary.json").read_text()
    assert '"updates": 2' in summary
    # goes on from the checkpoint: two more updates
    args[-1] = "16"
    assert train.main(args) == 0
    assert "resumed from" in capsys.readouterr().out
    second = pickle.loads((out_dir / "checkpoint.pkl").read_bytes())
    assert second["steps"] == 16 and second["opt_state"]["count"] == 4
    moved = [np.abs(a - b).max() for (_, a), (_, b) in zip(
        flat_items(first["params"]), flat_items(second["params"]))]
    assert max(moved) > 0


def test_train_cli_device_rules(tmp_path):
    """--n_devices N > 1 on the default device needs N cards (data
    parallelism, tests/test_torch_parallel.py); without a GPU the default
    device raises."""
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="CUDA devices"):
            train.main(TRAIN_ARGS[:-2] + ["--n_devices", "2", "--train_dir", str(tmp_path)])
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--env", "Empty", "--train_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        TL.Learner(t_make_scenario("Empty"), 1)


def test_resolve_task_list():
    assert train.resolve_task_list("Collect") == ["Collect"]
    assert train.resolve_task_list("multitask_megaverse8") == [
        "TowerBuilding", "ObstaclesEasy", "ObstaclesHard", "Collect", "Sokoban",
        "HexMemory", "HexExplore", "Rearrange"]
    assert train.resolve_task_list("multitask_obstacles") == [
        "ObstaclesWalls", "ObstaclesSteps", "ObstaclesLava", "ObstaclesEasy", "ObstaclesHard"]
    with pytest.raises(NotImplementedError):
        train.resolve_task_list("multitask_other")


def test_enjoy_plays_port_and_jax_checkpoints_without_jax(tmp_path):
    """enjoy loads a checkpoint of the port's trainer and one in the JAX
    trainer's format (optax state classes pickled beside the params) in a
    process that never imports jax, jaxlib, flax or optax."""
    import optax

    train.main(TRAIN_ARGS + ["--train_dir", str(tmp_path), "--train_for_env_steps", "4"])
    port_ckpt = tmp_path / "default" / "checkpoint.pkl"
    model = JActorCritic(hidden_size=HIDDEN)
    params = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 72, 128, 3), jnp.uint8))
    tx = optax.chain(optax.clip_by_global_norm(4.0), optax.adam(1e-4))
    jax_ckpt = tmp_path / "jax_checkpoint.pkl"
    with open(jax_ckpt, "wb") as f:
        pickle.dump({"params": jax.tree.map(np.asarray, params),
                     "opt_state": jax.tree.map(np.asarray, tx.init(params)),
                     "steps": 123}, f)
    assert b"optax" in jax_ckpt.read_bytes()
    code = (
        "import sys\n"
        "from megaverse_tpu_torch.rl import enjoy\n"
        "for ck in sys.argv[1:]:\n"
        "    assert enjoy.main(['--env', 'Empty', '--num_agents_per_env', '2',"
        " '--hidden_size', '32', '--device', 'cpu', '--episodes', '1', '--max_steps', '3',"
        " '--checkpoint', ck]) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'megaverse_tpu'))\n"
        "print('BAD=' + ','.join(bad))\n")
    path = [ROOT] + [p for p in sys.path if p]
    out = subprocess.run([sys.executable, "-S", "-E", "-c",
                          f"import sys; sys.path[:0] = {path!r}\n" + code,
                          str(port_ckpt), str(jax_ckpt)],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("loaded checkpoint at") == 2, out.stdout
    assert "loaded checkpoint at 4 steps" in out.stdout and "at 123 steps" in out.stdout
    assert out.stdout.strip().endswith("BAD="), out.stdout


def test_enjoy_reads_the_jax_params_exactly(tmp_path):
    """The params enjoy loads from a JAX-format checkpoint are the flax ones."""
    model = JActorCritic(hidden_size=HIDDEN)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(2),
                                                 jnp.zeros((1, 72, 128, 3), jnp.uint8)))
    path = tmp_path / "c.pkl"
    path.write_bytes(pickle.dumps({"params": params, "steps": 1}))
    from megaverse_tpu_torch.rl.checkpoint import load_checkpoint
    torch_port_checks.assert_trees_equal(load_checkpoint(path)["params"], params)
    assert enjoy.main(["--env", "Empty", "--hidden_size", "32", "--device", "cpu",
                       "--episodes", "1", "--max_steps", "2", "--checkpoint", str(path)]) == 0


def test_refill_regenerates_the_envs_that_reset(tmp_path):
    """After each rollout the trainer regenerates the buffered layouts of
    exactly the envs that reset during it (num_frames < rollout), one
    rollout later on the asynchronous path; other slots keep theirs."""
    args = train.parse_args(TRAIN_ARGS + ["--train_dir", str(tmp_path)])
    cfg = TL.TrainConfig(rollout=2, hidden_size=HIDDEN)
    task = train._Task("Collect", args, cfg, seed=3, device=torch.device("cpu"))
    try:
        assert task.async_refill        # Collect: episodes of 60 s and more >= 3 * 2 ticks
        before = task.next_scenes.props.pos.clone()
        frames = task.ls.env_state.num_frames
        task.ls = task.ls._replace(env_state=task.ls.env_state.replace(
            num_frames=torch.tensor([1, 7], dtype=frames.dtype)))
        task.refill()                   # env 0 reset: its layout is generated now...
        assert torch.equal(task.next_scenes.props.pos, before)
        task.ls = task.ls._replace(env_state=task.ls.env_state.replace(
            num_frames=torch.tensor([9, 9], dtype=frames.dtype)))
        task.refill()                   # ...and lands before the rollout after next
        after = task.next_scenes.props.pos
        assert not torch.equal(after[0], before[0]) and torch.equal(after[1], before[1])
        # the same draw as env 0's own generator stream gives
        gens = [np.random.Generator(np.random.PCG64(s))
                for s in np.random.SeedSequence(3).spawn(2)]
        for _ in range(3):
            want = task.scenario.generate_checked(gens[0])
        np.testing.assert_array_equal(after[0].numpy(), np.asarray(want.props.pos))
    finally:
        task.close()
