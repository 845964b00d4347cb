"""What the benchmark may load: nothing that `run.py` runs imports JAX or the
JAX package (top-level names compared whole, so `megaverse_tpu_torch`
passes), the reference imports nothing of the program, and the command
refuses to run without a card."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

import harness as H

BENCH = H.BENCH_DIR


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_names_compare_whole():
    assert H.forbidden_loaded(["megaverse_tpu_torch", "megaverse_tpu_torch.env"]) == []
    assert H.forbidden_loaded(["megaverse_tpu.env", "jax.numpy", "jaxlib"]) == \
        ["jax", "jaxlib", "megaverse_tpu"]
    assert H.forbidden_loaded(["jaxtyping", "flaxen"]) == []


def test_no_file_of_the_benchmark_imports_jax():
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(H.FORBIDDEN_MODULES), path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"megaverse_tpu_torch", *H.FORBIDDEN_MODULES}, path


def _loaded_after(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=BENCH, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=f"{BENCH}{os.pathsep}{H.ROOT}"))
    assert out.returncode == 0, out.stderr[-2000:]
    return eval(out.stdout.strip().splitlines()[-1])


def test_what_a_run_loads_holds_no_jax():
    tops = _loaded_after(
        "import run, harness, judge, faults, control\n"
        "from reference import policy, roofline, flops\n"
        "import reference.sim.env, reference.sim.scenarios.collect\n"
        "c = harness.Cell(harness.load_benchmark(), 'appo.collect_1024x1')\n"
        "harness.load_driver(c)\n"
        "c = harness.Cell(harness.load_benchmark(), 'sampler.collect_1024x1')\n"
        "harness.load_driver(c)\n"
        "[harness.load_metric(m['name']) for m in harness.load_benchmark()['per_layer']]\n"
        "import megaverse_tpu_torch.vector_env, megaverse_tpu_torch.rl.train\n"
        "import megaverse_tpu_torch.parallel.mesh\n")
    assert "megaverse_tpu_torch" in tops
    assert H.forbidden_loaded(tops) == []


def test_reference_alone_loads_no_program():
    tops = _loaded_after("from reference import policy, roofline, flops\n"
                         "import reference.sim.env, reference.sim.scenarios.collect\n"
                         "import judge")
    assert not set(tops) & {"megaverse_tpu_torch", *H.FORBIDDEN_MODULES}


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "sampler.collect_1024x1", "--seed", str(2 ** 31 + 5), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=H.ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_rank_that_loads_jax_fails_the_run():
    from bench_helpers import jax_on_rank_1, run_small

    with pytest.raises(RuntimeError, match="a rank failed"):
        run_small("sampler.collect_1024x1", 2 ** 31 + 77, ranks=2, prepare=jax_on_rank_1)
    assert "jax" not in sys.modules
