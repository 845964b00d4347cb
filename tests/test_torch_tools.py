"""The port's tools on the CPU: utils/mazelib.py (mirrors of
tests/test_mazes.py, and the same mazes as the JAX package's copy from the
same seed), rl/runs.py (its commands run the port's trainer, its
sampling_benchmark run bench_torch.py), the pyproject console scripts,
scripts/scaling_curve_torch.py (gloo ranks on the CPU),
utils/logging.py, and the scripts scripts/*_torch.py driven through their
`main` (record_episode_torch at 24 px with the free camera's overview,
eval_policy_torch on a port and a JAX-format checkpoint at the network's
72 x 128, mazegen_torch, viewer_app_torch's step)."""

import base64
import importlib.util
import io
import json
import os
import pickle
import tomllib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from megaverse_tpu.models.actor_critic import ActorCritic as JActorCritic
from megaverse_tpu.utils import mazelib as JM

from megaverse_tpu_torch.convert import actor_critic_from_flax
from megaverse_tpu_torch.rl import runs
from megaverse_tpu_torch.rl.checkpoint import save_checkpoint
from megaverse_tpu_torch.rl.learner import adam_init
from megaverse_tpu_torch.utils import logging as TLOG
from megaverse_tpu_torch.utils import mazelib as TM

import torch_port_checks  # noqa: F401  (one torch thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SHAPES = {
    "rectangular": lambda M: M.rectangular_maze(7, 5),
    "honeycomb": lambda M: M.honeycomb_maze(4),
    "circular": lambda M: M.circular_maze(4),
    "hexagonal": lambda M: M.hexagonal_maze(3),
    "circularhexagon": lambda M: M.circular_hexagon_maze(3),
}
ALGORITHMS = ["kruskal", "dfs", "bfs", "prim", "lerw"]


def script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts",
                                                                     name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _components(maze) -> int:
    n = len(maze.centers)
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for k, (i, j, _) in enumerate(maze.interior):
        if maze.removed[k]:
            parent[find(i)] = find(j)
    return len({find(i) for i in range(n)})


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_spanning_tree(shape, algorithm):
    """A perfect maze (test_mazes.py::test_spanning_tree), and the JAX
    package's copy removes the same borders from the same seed."""
    maze = SHAPES[shape](TM)
    maze.generate(np.random.default_rng(3), algorithm)
    n = len(maze.centers)
    assert int(maze.removed.sum()) == n - 1
    assert _components(maze) == 1
    ref = SHAPES[shape](JM).generate(np.random.default_rng(3), algorithm)
    np.testing.assert_array_equal(maze.centers, ref.centers)
    np.testing.assert_array_equal(maze.removed, ref.removed)


def test_cell_counts_match_reference():
    assert len(TM.hexagonal_maze(3).centers) == 6 * 9
    assert len(TM.honeycomb_maze(4).centers) == 1 + 3 * 4 * 3
    assert len(TM.circular_hexagon_maze(3).centers) == 6 * (1 + 3 + 5)


def test_generation_seed_deterministic():
    a = TM.honeycomb_maze(4).generate(np.random.default_rng(11), "kruskal")
    b = TM.honeycomb_maze(4).generate(np.random.default_rng(11), "kruskal")
    assert np.array_equal(a.removed, b.removed)
    c = TM.honeycomb_maze(4).generate(np.random.default_rng(12), "kruskal")
    assert not np.array_equal(a.removed, c.removed)


def test_user_maze():
    centers = [(0, 0), (1, 0), (1, 1), (0, 1)]
    ring = [(0, 1, (0.5, -0.5, 0.5, 0.5)), (1, 2, (0.5, 0.5, 1.5, 0.5)),
            (2, 3, (0.5, 0.5, 0.5, 1.5)), (3, 0, (-0.5, 0.5, 0.5, 0.5))]
    maze = TM.user_maze(centers, ring).generate(np.random.default_rng(0))
    assert int(maze.removed.sum()) == 3 and _components(maze) == 1


def test_outputs_and_mazegen(tmp_path):
    maze = TM.hexagonal_maze(2).generate(np.random.default_rng(0))
    svg, plt = tmp_path / "m.svg", tmp_path / "m.plt"
    maze.to_svg(str(svg))
    maze.to_gnuplot(str(plt))
    assert "<svg" in svg.read_text() and "line" in svg.read_text()
    body = plt.read_text()
    assert "set arrow" in body and body.strip().endswith("plot -100 notitle")
    out = tmp_path / "cli.svg"
    assert script("mazegen_torch").main(["--shape", "circular", "--size", "3",
                                         "--algorithm", "prim", "--svg", str(out)]) == 0
    ref = tmp_path / "ref.svg"
    JM.circular_maze(3).generate(np.random.default_rng(0), "prim").to_svg(str(ref))
    assert out.read_text() == ref.read_text()


def test_runs_name_the_ports_trainer(capsys):
    assert set(runs.RUNS) == {"megaverse8_single_agent", "megaverse8_multi_agent",
                              "megaverse8_multitask", "sampling_benchmark",
                              "training_benchmark"}
    for name, run in runs.RUNS.items():
        for _, cmd in run.commands():
            if name == "sampling_benchmark":
                assert cmd.split()[1].endswith("bench_torch.py"), cmd
            else:
                assert " -m megaverse_tpu_torch.rl.train " in cmd, cmd
    assert len(runs.RUNS["megaverse8_single_agent"].commands()) == 8 * 5
    assert runs.main(["--run", "megaverse8_multi_agent", "--dry", "--max_runs", "2",
                      "--train_dir", "/nonexistent"]) == 0
    out = capsys.readouterr().out
    assert out.count("megaverse_tpu_torch.rl.train") == 2
    assert "--train_dir=/nonexistent --experiment=megaverse_2ag_env_TowerBuilding_seed_11111" in out


def test_logging_levels_and_profiler():
    """The copy keeps the reference's level numbering and timers, under the
    port's logger name."""
    import logging

    level = TLOG.log().level
    try:
        TLOG.set_log_level(2)
        assert TLOG.log().name == "megaverse_tpu_torch"
        assert TLOG.log().level == logging.WARNING
    finally:
        TLOG.log().setLevel(level)
    prof = TLOG.Profiler()
    for _ in range(2):
        with prof.span("x"):
            pass
    assert prof.summary().startswith("x: ") and "2 calls" in prof.summary()


def test_record_episode_with_overview(tmp_path):
    out = tmp_path / "ep"
    assert script("record_episode_torch").main(
        ["--env", "Empty", "--num_agents", "2", "--steps", "2", "--device", "cpu",
         "--obs_height", "24", "--overview", "--gif", "--out", str(out)]) == 0
    from PIL import Image

    frame = np.asarray(Image.open(out / "frame_0000.png"))
    assert frame.shape == (24 + 128, 2 * 128, 3)
    assert len(np.unique(frame[24:].reshape(-1, 3), axis=0)) > 3   # the overview is drawn
    assert (out / "episode.gif").exists()


def test_eval_policy_port_and_jax_checkpoints(tmp_path, capsys):
    """The same flax parameters as a JAX-format checkpoint and as the port's
    give the same greedy evaluation."""
    model = JActorCritic(hidden_size=32)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(4),
                                                 jnp.zeros((1, 72, 128, 3), jnp.uint8)))
    jax_ckpt = tmp_path / "jax.pkl"
    jax_ckpt.write_bytes(pickle.dumps({"params": params, "steps": 5}))
    port_ckpt = tmp_path / "port.pkl"
    tparams = actor_critic_from_flax(params)
    save_checkpoint(port_ckpt, tparams, adam_init(tparams), 5)
    outs = []
    for ck in (jax_ckpt, port_ckpt):
        assert script("eval_policy_torch").main(
            ["--env", "Empty", "--checkpoint", str(ck), "--num_envs", "2", "--steps", "3",
             "--hidden_size", "32", "--device", "cpu"]) == 0
        outs.append(capsys.readouterr().out)
    assert "greedy reward/step mean" in outs[0] and outs[0] == outs[1]


def test_viewer_steps_and_renders(tmp_path):
    viewer = script("viewer_app_torch")
    state = viewer.ViewerState("Empty", 2, seed=1, hires=1, device="cpu")
    try:
        from PIL import Image

        first = state.step(["KeyW", "ArrowLeft"])
        img = np.asarray(Image.open(io.BytesIO(base64.b64decode(first["frame"]))))
        assert img.shape == (72, 128, 3) and first["frame_no"] == 1
        over = state.step(["KeyO", "KeyQ"])
        assert over["overview"] and over["consumed"] == ["KeyO"]
        assert state.step(["Tab"])["agent"] == 1
    finally:
        state.env.close()


@pytest.fixture
def one_thread(monkeypatch):
    """The spawned ranks inherit this: one intra-op thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_scaling_curve_two_rows(one_thread, capsys):
    curve = script("scaling_curve_torch")
    assert curve.main(["--device", "cpu", "--devices", "1,2", "--num_envs", "4",
                       "--chunk", "4", "--chunks", "1"]) == 0
    rows = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert [r["n_devices"] for r in rows] == [1, 2]
    assert rows[0]["vs_1dev"] == 1.0
    assert all(r["obs_per_sec"] > 0 and r["gpu"] == "cpu" for r in rows)


def test_sampling_benchmark_run(capsys):
    cmds = runs.RUNS["sampling_benchmark"].commands()
    assert [name for name, _ in cmds] == [
        f"benchmark_megaverse_scenario_{s}" for s in ("ObstaclesHard", "Empty", "Collect")]
    for _, cmd in cmds:
        assert cmd.split()[1] == os.path.join(ROOT, "bench_torch.py")
    assert runs.main(["--run", "sampling_benchmark", "--dry"]) == 0
    assert capsys.readouterr().out.count("bench_torch.py --scenario=") == 3


def test_console_scripts_resolve():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    want = {"megaverse-tpu-torch-bench": "megaverse_tpu_torch.cli:bench_main",
            "megaverse-tpu-torch-train": "megaverse_tpu_torch.rl.train:main",
            "megaverse-tpu-torch-enjoy": "megaverse_tpu_torch.rl.enjoy:main"}
    for name, target in want.items():
        assert scripts[name] == target
        mod, fn = target.split(":")
        assert callable(getattr(importlib.import_module(mod), fn))
    # the JAX package's three stay
    assert scripts["megaverse-tpu-bench"] == "megaverse_tpu.cli:bench_main"
