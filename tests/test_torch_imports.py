"""The port stands alone: importing megaverse_tpu_torch (and every submodule)
pulls in neither JAX nor the JAX package, and neither chip_smoke.py,
bench_torch.py nor the port's scripts (scripts/*_torch.py) names either."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def submodules():
    pkg_dir = os.path.join(ROOT, "megaverse_tpu_torch")
    names = ["megaverse_tpu_torch"]
    for m in pkgutil.walk_packages([pkg_dir], prefix="megaverse_tpu_torch."):
        names.append(m.name)
    return sorted(names)


def port_scripts():
    return sorted(os.path.join(ROOT, "scripts", f) for f in os.listdir(os.path.join(ROOT, "scripts"))
                  if f.endswith("_torch.py"))


def test_every_submodule_imports_without_jax():
    """Every module of the port, bench_torch.py and every script/*_torch.py
    (module level)."""
    code = (
        "import importlib, importlib.util, sys\n"
        f"names = {submodules()!r}\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        f"for path in {port_scripts() + [os.path.join(ROOT, 'bench_torch.py')]!r}:\n"
        "    spec = importlib.util.spec_from_file_location('script', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'megaverse_tpu'))\n"
        "print('BAD=' + ','.join(bad))\n"
    )
    # -S -E: no site customisation, so nothing but the port's own imports runs
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT] + [p for p in sys.path if p]))
    out = subprocess.run([sys.executable, "-S", "-E", "-c",
                          "import sys; sys.path[:0] = %r\n" % env["PYTHONPATH"].split(os.pathsep)
                          + code],
                         capture_output=True, text=True, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "BAD=\n" in out.stdout + "\n" and out.stdout.strip().endswith("BAD="), out.stdout


def test_expected_modules_exist():
    names = set(submodules())
    for want in ("constants", "types", "env", "vector_env", "convert", "ops.grid",
                 "ops.physics", "ops.raycast", "ops.raycast_cuda", "scenarios.base",
                 "scenarios.empty", "scenarios.components", "scenarios.tower_building",
                 "scenarios.collect", "scenarios.obstacles", "scenarios.platforms",
                 "scenarios.sokoban", "scenarios.rearrange", "scenarios.box_a_gone",
                 "scenarios.football", "scenarios.hex", "ops.pvs", "utils.refrng",
                 "utils.synthetic", "utils.perlin", "utils.refperlin", "utils.refsort",
                 "utils.boxoban", "utils.native", "utils.hexmaze", "utils.pvs",
                 "models.actor_critic", "rl.learner", "rl.train", "rl.enjoy",
                 "rl.wrappers", "rl.checkpoint", "gym_env", "rl.runs", "utils.logging",
                 "utils.mazelib", "parallel", "parallel.distributed", "parallel.mesh",
                 "entry", "cli"):
        assert f"megaverse_tpu_torch.{want}" in names, want
    assert os.path.exists(os.path.join(ROOT, "megaverse_tpu_torch", "csrc", "render.cu"))


@pytest.mark.parametrize("path", ["chip_smoke.py", "bench_torch.py",
                                  "scripts/torch_dispatch_count.py",
                                  "scripts/profile_torch_step.py",
                                  "scripts/learner_grad_agreement.py"] + sorted(
    os.path.relpath(p, ROOT) for p in port_scripts()) + sorted(
    os.path.join(dp, f)[len(ROOT) + 1:]
    for dp, _, fs in os.walk(os.path.join(ROOT, "megaverse_tpu_torch"))
    for f in fs if f.endswith(".py")))
def test_sources_do_not_import_jax_or_the_jax_package(path):
    src = open(os.path.join(ROOT, path)).read()
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|megaverse_tpu)(\.|\s|$)", re.M)
    assert not pat.search(src), path


def test_vector_env_defaults_to_cuda_and_raises_without_gpu():
    import torch

    from megaverse_tpu_torch import VectorEnv
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA"):
        VectorEnv("Empty", num_envs=2)
