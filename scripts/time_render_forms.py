"""Time the render kernel's forms on one GPU at the state chip_smoke.py's main
path ends on.

    python3 scripts/time_render_forms.py --tables FILE [--package-root DIR]
        [--source CU ...]

1. If FILE does not exist, drive Collect 1024 x 1 and TowerBuilding 1024 x 1
   through `VectorEnv` as chip_smoke.py does (seed 42, reset, three
   `step_many` chunks of 64 steps with its action pool, flush) and save the
   renderer's input tables there (torch.save). Several runs of the script
   (for instance one per tree) then time the same inputs.
2. Import `megaverse_tpu_torch` from DIR (default: this checkout), build its
   kernel (or, for each `--source`, that variant of csrc/render.cu instead),
   and time each case: milliseconds per call (CUDA events, mean of 20 calls
   after one untimed call), clusters run per pixel (the kernel's
   `visits`), and the registers and spills ptxas reported for each
   instantiation of the kernel template; with this checkout's package also
   the live clusters per env (what B3 votes on) and the clusters per frame
   that B6 over B2 can visit (mean, largest, and the frames with more than
   the FRAME_K it stages; the rest go through its ring).

Cases: b1 (no cull tables), every case of `utils.synthetic.form_tables`
(b2, b3, the four B4 variants b4_agent, b4_agent_dist, b4_tile and
b4_shuffled, b5), and the merged launch (B6) over b1, b2, b3, b4_tile and
b5. Prints one JSON line per (source, scenario) and the card's name and
power limit. Needs a GPU; it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
SCENARIOS = (("Collect", 1024), ("TowerBuilding", 1024))
CASES = ("b1", "b2", "b3", "b4_agent", "b4_agent_dist", "b4_tile", "b4_shuffled", "b5",
         "b6_over_b1", "b6_over_b2", "b6_over_b3", "b6_over_b4_tile", "b6_over_b5")


def make_tables(path: Path) -> None:
    """The renderer's inputs at the main path's end state, saved to `path`."""
    sys.path.insert(0, str(REPO))
    from chip_smoke import Smoke
    from megaverse_tpu_torch import VectorEnv
    from megaverse_tpu_torch.env import UNCULLED, render_tables
    saved = {}
    for name, envs in SCENARIOS:
        env = VectorEnv(name, envs, 1, seed=42)
        pool = Smoke.action_pool(envs, 1)
        env.reset()
        for _ in range(3):
            env.step_many(pool, 64)
        env.flush()
        tabs = render_tables(env.scenario, env.state, bucket=env._bucket, mode=UNCULLED)
        saved[name] = dict(cams=tabs["cams"].cpu(), prims=tabs["prims"].cpu(),
                           height=env.scenario.cfg.obs_height,
                           ui=bool(tabs["ui_indicators"]))
        env.close()
    torch.save(saved, path)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tables", required=True, type=Path)
    ap.add_argument("--package-root", type=Path, default=REPO)
    ap.add_argument("--source", nargs="*", type=Path, default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_render_forms: no CUDA device", file=sys.stderr)
        return 2
    if not args.tables.exists():
        make_tables(args.tables)
    sys.path.insert(0, str(REPO))
    from chip_smoke import nvidia_smi_line, ptxas_summary, time_cuda
    sys.path.insert(0, str(args.package_root.resolve()))
    from megaverse_tpu_torch.ops import raycast_cuda as RC
    from megaverse_tpu_torch.utils.synthetic import form_tables
    if not Path(RC.__file__).resolve().is_relative_to(args.package_root.resolve()):
        raise RuntimeError(f"imported {RC.__file__}, not from {args.package_root}")
    dev = torch.device("cuda", 0)
    build = RC.build_library
    sources = [s.resolve() for s in args.source] or [RC.CSRC_DIR / "render.cu"]
    with ThreadPoolExecutor(len(sources)) as pool:   # one nvcc per source, together
        list(pool.map(build, sources))
    saved = torch.load(args.tables)
    smi = nvidia_smi_line()
    for src in sources:
        RC._lib = None
        RC.build_library = functools.partial(build, src)
        RC.load_library()
        log = (RC.BUILD_DIR / f"{src.stem}.nvcc.log")
        regs = ptxas_summary(log.read_text()) if log.exists() else {}
        for name, t in saved.items():
            cams, prims = t["cams"].to(dev), t["prims"].to(dev)
            height, ui = t["height"], t["ui"]
            tabs = {"b1": dict(prims=prims)}
            tabs.update(form_tables(cams, prims, height, 128))
            cases = {}
            for case in CASES:
                kw = dict(tabs[case.removeprefix("b6_over_")])
                if case.startswith("b6_over_"):
                    kw["merge_tiles"] = True
                run = functools.partial(RC.render_packed, cams, height=height, width=128,
                                        ui_indicators=ui, **kw)
                ms = time_cuda(run, 20)
                per_pixel = None
                if case != "b1":
                    visits = RC.new_visits(cams, height)
                    run(visits=visits)
                    torch.cuda.synchronize()
                    # a tree from before VISIT_SEGMENTS counted per pixel row
                    seg = getattr(RC, "VISIT_SEGMENTS", 1)
                    per_pixel = visits.sum().item() / (cams.shape[0] * cams.shape[1] * height
                                                       * seg)
                cases[case] = dict(ms=ms, clusters_run_per_pixel=per_pixel)
            line = {"package": str(args.package_root), "source": str(src),
                    "scenario": f"{name} {cams.shape[0]}x{cams.shape[1]}",
                    "rows": int(prims.shape[1]), "cases": cases, "ptxas": regs, "gpu": smi}
            if hasattr(RC, "frame_clusters_plain"):
                # what B3 lists per env and B6 over B2 stages per frame
                live = RC.live_clusters(tabs["b3"]["clusters"]).sum(dim=1).float()
                b2 = tabs["b2"]
                frame = RC.frame_clusters_plain(b2["clbits"], b2["cdist"],
                                                b2["clusters"].shape[1]).sum(dim=2).float()
                line.update(live_clusters_per_env=[live.mean().item(), live.max().item()],
                            frame_clusters=[frame.mean().item(), frame.max().item()],
                            frames_over_frame_k=int((frame > RC.FRAME_K).sum().item()))
            print(json.dumps(line), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
