"""Run one cell of the benchmark of megaverse_tpu_torch and print its result.

    python3 benchmarks/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of BENCHMARK.json's `workloads`; its configuration,
traffic and driver are files found by name (see harness.py). The run makes
its inputs from `--seed`, warms up every shape it uses (set-up, reported as
`setup_s`), measures for `--seconds`, then judges what the timed path
produced against the plain reference under `reference/`, and prints, as the
last line of standard output, one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer metrics), `device`, with `--trace 1` `breakdown`, and last
`checks`, each compared number with its limit (also the last lines of
standard error).

It needs a CUDA device (four for a four-chip cell: one process per card,
rank 0 in this process) and exits non-zero, printing no result, without
them, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.append(ROOT)

import harness as H  # noqa: E402


def fail(msg: str) -> int:
    print(f"benchmarks/run.py: {msg}", file=sys.stderr, flush=True)
    return 2


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_rank(rank: int, world: int, port: int, workload: str, seed: int, seconds: float,
             trace: int, device_type: str = "cuda", control: bool = False, fault: str = None,
             overrides: dict = None, prepare=None):
    """One rank of a cell: its driver's run (with `fault` planted in the
    program, or the `control` judged in its place: see control.py;
    `overrides` updates the cell's traffic and config, and `prepare(rank)`,
    a module-level function, runs first in every rank: both for the tests'
    small sizes). Returns the driver's result on rank 0 (None elsewhere)."""
    import torch

    if prepare is not None:
        prepare(rank)
    cell = H.Cell(H.load_benchmark(), workload)
    for part, values in (overrides or {}).items():
        getattr(cell, part).update(values)
    driver = H.load_driver(cell)
    undo = None
    if fault:
        import faults

        undo = faults.plant(fault, cell.driver)
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    if world > 1:
        import torch.distributed as dist

        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                init_method=f"tcp://localhost:{port}", world_size=world,
                                rank=rank, device_id=(torch.device("cuda", rank)
                                                      if device_type == "cuda" else None))
    try:
        result = driver.run(cell, seed=seed, seconds=seconds, trace=bool(trace),
                            device=torch.device(device_type, rank) if device_type == "cuda"
                            else torch.device("cpu"), rank=rank, world=world,
                            t_start=T_START, control=control)
        return result if rank == 0 else None
    finally:
        if undo is not None:
            undo()
        if world > 1:
            import torch.distributed as dist

            dist.barrier()
            dist.destroy_process_group()


def _child(*args):
    """A rank other than 0; it exits non-zero if JAX or the JAX package was
    loaded in it by the time its run ended."""
    run_rank(*args)
    loaded = H.forbidden_loaded(sys.modules)
    if loaded:
        print(f"benchmarks/run.py: rank {args[0]} loaded forbidden modules: {loaded}",
              file=sys.stderr, flush=True)
        sys.exit(3)


def run_cell(cell: "H.Cell", seed: int, seconds: float, trace: int, device_type: str = "cuda",
             control: bool = False, fault: str = None, overrides: dict = None,
             prepare=None) -> dict:
    """A run of `cell`: ranks 1.. in spawned processes, rank 0 here. Returns
    rank 0's result; raises RuntimeError where another rank failed."""
    world = cell.chips
    port = free_port() if world > 1 else 0
    procs = []
    if world > 1:
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        for r in range(1, world):
            p = ctx.Process(target=_child, args=(r, world, port, cell.name, seed, seconds, trace,
                                                 device_type, control, fault, overrides,
                                                 prepare))
            p.start()
            procs.append(p)
    try:
        result = run_rank(0, world, port, cell.name, seed, seconds, trace, device_type,
                          control, fault, overrides, prepare)
    except BaseException:
        for p in procs:     # ranks left waiting in a collective would hang
            p.terminate()
        raise
    finally:
        for p in procs:
            p.join()
    if any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"a rank failed: exit codes {[p.exitcode for p in procs]}")
    return result


def read_metrics(cell: "H.Cell", result: dict, trace: bool) -> dict:
    """The cell's end-to-end metrics (trace off) or its per-layer metrics,
    each from its reader (trace on); a reader that finds nothing to read
    returns None and the metric is left out."""
    out = {}
    if not trace:
        for m in cell.end_to_end:
            out[m["name"]] = {"value": result["end_to_end"][m["name"]], "unit": m["unit"]}
        return out
    for m in cell.per_layer:
        value = H.load_metric(m["name"], cell.root).read(result)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    args = H.parse_args(argv)
    try:
        bench = H.load_benchmark()
        cell = H.Cell(bench, args.workload)
    except (OSError, KeyError, ValueError) as exc:
        return fail(f"cannot load the cell: {exc}")
    os.environ.update(H.cache_environment())
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < cell.chips:
        return fail(f"{cell.name} needs {cell.chips} CUDA devices, "
                    f"{torch.cuda.device_count()} present")
    print(f"card: {H.power_limit()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          file=sys.stderr, flush=True)
    try:
        result = run_cell(cell, args.seed, args.seconds, args.trace)
    except RuntimeError as exc:
        return fail(str(exc))

    loaded = H.forbidden_loaded(sys.modules)
    if loaded:
        return fail(f"forbidden modules loaded: {loaded}")
    metrics = read_metrics(cell, result, bool(args.trace))
    checks = result["checks"]
    line = {"correct": H.is_correct(checks), "attempted": result["attempted"],
            "failed": result["failed"], "metrics": metrics, "device": result["device"]}
    if args.trace:
        line["breakdown"] = result["breakdown"]
    for k, v in result.get("notes", {}).items():
        print(f"{k}: {v}", file=sys.stderr, flush=True)
    line["checks"] = H.checks_line(checks)
    H.print_checks(checks)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
