"""Render size classes of the port's VectorEnv must be invisible in results
(mirrors of tests/test_render_classes.py, port against port, on the CPU).

With MEGAVERSE_CLASSES=1 the env batch is partitioned by live render-row
counts and each class renders through its own table size; frames and
rewards must be bit-identical to the unpartitioned render, across
auto-resets, refills, and multi-group padded partitions. The frames are
24 px high to keep the plain renderer's CPU time small.
"""

import dataclasses

import numpy as np
import torch

import megaverse_tpu_torch.constants as C
from megaverse_tpu_torch import VectorEnv

import torch_port_checks as K  # noqa: F401  (one torch thread)


def _rollout(name, classes_on, monkeypatch, num_envs=32, steps=8, seed=31, **params):
    if classes_on:
        monkeypatch.setenv("MEGAVERSE_CLASSES", "1")
        monkeypatch.delenv("MEGAVERSE_NO_CLASSES", raising=False)
    else:
        monkeypatch.delenv("MEGAVERSE_CLASSES", raising=False)
        monkeypatch.setenv("MEGAVERSE_NO_CLASSES", "1")
    env = VectorEnv(name, num_envs=num_envs, num_agents_per_env=1, seed=seed,
                    params=params or None, device="cpu")
    try:
        env.scenario.cfg = dataclasses.replace(env.scenario.cfg, obs_height=24)
        frames = [env.reset().clone()]
        rng = np.random.default_rng(8)
        rews = []
        for _ in range(steps):
            md = np.stack([rng.integers(0, s, size=(num_envs, 1))
                           for s in C.ACTION_SPACE_SIZES], axis=-1)
            obs, rew, done, _ = env.step(md)
            frames.append(obs.clone())
            rews.append(rew.clone())
        used = env._use_classes
        groups = [(k, int(i.shape[0])) for k, i in env._cls_groups] if used else []
        return torch.stack(frames), torch.stack(rews), used, groups, env.num_refills
    finally:
        env.close()


def test_classes_match_full_render_with_resets(monkeypatch):
    """Forced-on classes over short episodes (refill + consume-buffer path)."""
    monkeypatch.setattr(VectorEnv, "_CLASS_MIN_ROWS", 0)
    monkeypatch.setattr(VectorEnv, "_CLASS_MIN_ENVS", 0)
    f_full, r_full, used, _, _ = _rollout(
        "Sokoban", False, monkeypatch, steps=20, **{C.P_EPISODE_LENGTH_SEC: 1.0})
    assert not used
    f_cls, r_cls, used, groups, refills = _rollout(
        "Sokoban", True, monkeypatch, steps=20, **{C.P_EPISODE_LENGTH_SEC: 1.0})
    assert used and groups and refills > 0
    assert torch.equal(f_full, f_cls)
    assert torch.equal(r_full, r_cls)


def test_classes_multi_group_collect(monkeypatch):
    """Collect's heavy-tailed layouts split into several padded groups; the
    reset frame and one stepped frame cover every group's gather, render and
    the inverse permutation."""
    monkeypatch.setattr(VectorEnv, "_CLASS_MIN_ENVS", 0)
    f_full, _, used, _, _ = _rollout("Collect", False, monkeypatch, num_envs=16, steps=1,
                                     seed=13)
    assert not used
    f_cls, _, used, groups, _ = _rollout("Collect", True, monkeypatch, num_envs=16, steps=1,
                                         seed=13)
    assert used and len(groups) >= 2
    assert torch.equal(f_full, f_cls)


def test_classes_are_off_by_default(monkeypatch):
    """The reference's rule on the TPU: on only with MEGAVERSE_CLASSES=1, and
    MEGAVERSE_NO_CLASSES wins; never below the size thresholds."""
    monkeypatch.delenv("MEGAVERSE_CLASSES", raising=False)
    monkeypatch.delenv("MEGAVERSE_NO_CLASSES", raising=False)
    make = lambda n=64: VectorEnv("Collect", num_envs=n, device="cpu", render=True)
    assert not make()._use_classes
    monkeypatch.setenv("MEGAVERSE_CLASSES", "1")
    assert make()._use_classes
    assert not make(8)._use_classes
    assert not VectorEnv("Empty", num_envs=64, device="cpu")._use_classes
    monkeypatch.setenv("MEGAVERSE_NO_CLASSES", "1")
    assert not make()._use_classes


def test_inverse_permutation_takes_each_envs_first_place(monkeypatch):
    """Groups pad with a repeated env index; the inverse permutation must
    point at the env's real place, and the ladder must cover every env's
    max(current, buffered) rows."""
    env = VectorEnv("Collect", num_envs=40, device="cpu", render=False)
    env.render_obs = True
    env.set_render_classes(True)
    rng = np.random.default_rng(0)
    caps = np.asarray([env._class_ladder[-1][0], *env._class_ladder[-1][1]])
    # heavy-tailed row counts, as Collect's layouts have
    draw = lambda: (rng.random((40, caps.size)) ** 4 * caps).astype(np.int32)
    env._cls_rows_cur, env._cls_rows_buf = draw(), draw()
    env._rebuild_class_groups()
    order = torch.cat([i for _, i in env._cls_groups]).numpy()
    inv = env._cls_inv.numpy()
    assert sorted(inv.tolist()) == sorted(set(inv.tolist()))
    np.testing.assert_array_equal(order[inv], np.arange(40))
    for e in range(40):
        assert inv[e] == np.nonzero(order == e)[0][0]
    rows = np.maximum(env._cls_rows_cur, env._cls_rows_buf)
    assert len(env._cls_groups) >= 2
    for k, idx in env._cls_groups:
        mb, pb = env._class_ladder[k]
        assert (rows[idx.numpy()] <= np.asarray([mb, *pb])).all()
        assert idx.shape[0] in (32, 40)
    env.close()


def test_classes_switched_on_for_a_driven_env(monkeypatch):
    """set_render_classes(True) on an env already stepped without classes
    (no new reset; rows read from the device tables): the next frames are
    the unclassed ones, bit for bit, and one render launches per group."""
    monkeypatch.delenv("MEGAVERSE_CLASSES", raising=False)
    env = VectorEnv("Collect", num_envs=8, device="cpu", seed=13)
    try:
        env.scenario.cfg = dataclasses.replace(env.scenario.cfg, obs_height=24)
        env.reset()
        act = np.full((8, 1), C.ACTION_FORWARD, np.int32)
        env.step(act)
        plain = env.render()
        env.set_render_classes(True)
        assert env._use_classes and len(env._cls_groups) >= 2
        rows = env._layout_rows(env.state.box_color, env.state.props.type)
        assert (rows[:, 0] == (env.state.box_color > 0).sum(1).numpy()).all()
        assert torch.equal(env.render(), plain)
        obs_cls, _, _, _ = env.step(act)
        env.set_render_classes(False)
        assert torch.equal(env.render(), obs_cls)
    finally:
        env.close()
