"""What every cell of the benchmark shares: finding a cell's files by name,
the run's arguments, the device checks, the statistics and the reduction of
a profiler trace, the result line.

A cell is an entry of BENCHMARK.json's `workloads`: its `config` names
`configs/<config>.json` (which names the driver, `drivers/<driver>.py`), its
`traffic` names `workloads/<traffic>.json`, and each per-layer metric is read
by `metrics/<name>.py`. Adding a configuration, a traffic mix, a driver or a
metric is adding files and entries; no file here changes.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

# Top-level module names that no process of the benchmark may hold.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "megaverse_tpu")

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): HBM bytes/s,
# float32 outside the tensor cores, bf16 on the tensor cores. A share of a
# peak is stated against these whatever the card's power limit, which the
# run prints beside it.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12


# ------------------------------------------------------------------ cells
def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path}: no BENCHMARK.json")
    return json.loads(path.read_text())


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


class Cell:
    """One workload of BENCHMARK.json with its configuration and traffic
    files loaded, and the metrics it reports."""

    def __init__(self, bench: dict, name: str, root: Path = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
        self.entry = cells[name]
        self.name = name
        self.root = root
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(root / self.config_entry["file"])
        self.traffic = load_json(bench_dir(root) / "workloads" / f"{self.entry['traffic']}.json")
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"] if self._reports(m)]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]

    def _reports(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    @property
    def driver(self) -> str:
        return self.config["driver"]


def bench_dir(root: Path) -> Path:
    return root / BENCH_DIR.name


def load_module(path: Path, name: str):
    """Import a file of the benchmark by its path under a module name of its
    own (drivers and metric readers are found by file name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_driver(cell: Cell):
    return load_module(bench_dir(cell.root) / "drivers" / f"{cell.driver}.py",
                       f"bench_driver_{cell.driver}")


def load_metric(name: str, root: Path = ROOT):
    safe = name.replace(".", "_").replace("-", "_")
    return load_module(bench_dir(root) / "metrics" / f"{name}.py", f"bench_metric_{safe}")


# ------------------------------------------------------------- arguments
def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_environment(root: Path = ROOT) -> Dict[str, str]:
    """Build and kernel caches at fixed paths inside the checkout (the
    program builds its kernels into its own `build/` folder there)."""
    cache = root / ".bench_cache"
    return {"TRITON_CACHE_DIR": str(cache / "triton"),
            "TORCH_EXTENSIONS_DIR": str(cache / "torch_extensions"),
            "CUDA_CACHE_PATH": str(cache / "cuda")}


def forbidden_loaded(modules: Iterable[str]) -> List[str]:
    """The forbidden top-level names among `modules`, compared whole (the
    part before the first dot), so `megaverse_tpu_torch` is not
    `megaverse_tpu`."""
    tops = {m.split(".", 1)[0] for m in modules}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


# ------------------------------------------------------------- statistics
def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile by nearest rank: the smallest value with at least
    q % of the values at or below it."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(s)))
    return float(s[k - 1])


def idle_share(busy_s: float, window_s: float) -> float:
    """The share, in %, of a window in which no operation ran on the device."""
    if window_s <= 0:
        raise ValueError("empty window")
    return 100.0 * (1.0 - busy_s / window_s)


# ---------------------------------------------------------- trace summary
# a kernel's name is kept to this many characters (template arguments make
# some run to thousands)
NAME_CHARS = 160
HOST_LAUNCH_PREFIXES = ("cudaLaunch", "cudaGraphLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset",
                        "cuMemcpy", "cuMemset")


def merged_busy(intervals: Sequence[Tuple[float, float]]) -> float:
    """Total length of the union of [start, end) intervals."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def idle_gaps(kernels: Sequence[Tuple[float, float]], labels: Sequence[Tuple[float, float, str]],
              window: Tuple[float, float], top: int = 10) -> List[List]:
    """The `top` longest stretches of the window in which no kernel ran,
    each named by the innermost host range (start, end, name) that held the
    gap's middle ("host" where none did): [[name, seconds], ...], times in
    seconds."""
    gaps = []
    end = window[0]
    for s, e in sorted(kernels):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if window[1] > end:
        gaps.append((end, window[1]))
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    out = []
    for s, e in gaps[:top]:
        mid = 0.5 * (s + e)
        inner = [(le - ls, name) for ls, le, name in labels if ls <= mid <= le]
        out.append([min(inner)[1] if inner else "host", e - s])
    return out


class TraceSummary:
    """What the metric readers take from one profiled stretch of a window:
    device kernels (name, start s, end s), host launch calls by name, the
    host's ranges (the driver's labels and every host operation the
    profiler recorded), and the stretch's wall seconds."""

    def __init__(self, kernels, host_calls: Dict[str, int], labels, window: Tuple[float, float]):
        self.kernels = kernels              # [(name, start, end)] seconds
        self.host_calls = host_calls
        self.labels = labels                # [(start, end, name)] seconds
        self.window = window

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return merged_busy([(s, e) for _, s, e in self.kernels])

    def kernel_seconds(self, match=lambda name: True) -> float:
        return sum(e - s for n, s, e in self.kernels if match(n))

    def kernel_count(self, match=lambda name: True) -> int:
        return sum(1 for n, _, _ in self.kernels if match(n))

    def host_call_count(self) -> int:
        return sum(self.host_calls.values())

    def top_ops(self, top: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for n, s, e in self.kernels:
            by[n] = by.get(n, 0.0) + (e - s)
        return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def gaps(self, top: int = 10) -> List[List]:
        return idle_gaps([(s, e) for _, s, e in self.kernels], self.labels, self.window, top)

    @classmethod
    def from_profiler(cls, prof, labels: Sequence[str], window: Tuple[float, float]):
        """From a finished torch.profiler.profile. `labels` are the driver's
        host ranges (mirrored on the device by the profiler, which is not
        device work); `window` is the profiled stretch in the profiler's
        clock (microseconds, as the events carry them)."""
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        kernels, host_calls, ranges = [], {}, []
        want = set(labels)
        lo, hi = window[0] * 1e-6, window[1] * 1e-6
        for ev in prof.events():
            s, e = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
            if ev.device_type == cuda:
                # the profiler mirrors annotated host ranges (the driver's
                # labels, NCCL's collectives) on the device: not device work
                if ev.name not in want and not getattr(ev, "is_user_annotation", False):
                    kernels.append((ev.name[:NAME_CHARS], s, e))
                continue
            if e > lo and s < hi:
                ranges.append((s, e, ev.name[:NAME_CHARS]))
            if ev.name.startswith(HOST_LAUNCH_PREFIXES) and lo <= s <= hi:
                host_calls[ev.name] = host_calls.get(ev.name, 0) + 1
        kernels = [(n, max(s, lo), min(e, hi)) for n, s, e in kernels if e > lo and s < hi]
        return cls(kernels, host_calls, ranges, (lo, hi))


def profiled_window(prof, first: str, last: str) -> Optional[Tuple[float, float]]:
    """(start of the first range named `first`, end of the last named
    `last`) in the profiler's microseconds; None where the window closed
    before a labelled range ran."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    host = [ev for ev in prof.events() if ev.device_type != cuda]
    starts = [ev.time_range.start for ev in host if ev.name == first]
    ends = [ev.time_range.end for ev in host if ev.name == last]
    if not starts or not ends:
        return None
    return min(starts), max(ends)


# ---------------------------------------------------------------- device
def sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def device_line(device, count: int) -> Dict[str, object]:
    """The result line's `device` (a CPU run, made by the tests only, says
    so: its numbers are never a device's)."""
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count}


def power_limit() -> str:
    """`name, power.limit` of the first card, as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


# ---------------------------------------------------------------- result
def checks_line(checks: Dict[str, Tuple[float, float]]) -> Dict[str, Dict[str, float]]:
    return {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}


def is_correct(checks: Dict[str, Tuple[float, float]]) -> bool:
    """Every compared number at or under its limit (a number that is not
    finite fails)."""
    return all(math.isfinite(v) and v <= lim for v, lim in checks.values())


def print_checks(checks: Dict[str, Tuple[float, float]], stream=sys.stderr) -> None:
    for k, (v, lim) in checks.items():
        print(f"check {k} = {v!r} limit {lim!r} {'ok' if math.isfinite(v) and v <= lim else 'FAIL'}",
              file=stream, flush=True)
