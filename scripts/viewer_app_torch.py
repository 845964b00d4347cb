#!/usr/bin/env python
"""Interactive viewer of the port (counterpart of scripts/viewer_app.py):
human control of a live env in the browser.

The reference `viewer_app` (src/apps/viewer_app.cpp:18-162, viewer.cpp:24-303)
opens an SDL2 window, steps ONE env with keyboard agent control, supports
agent switching and an overview fly-cam. Headless, the same loop is served
over HTTP: a canvas page polls `/step` at the simulation rate with the keys
held; the server converts them to the reference action bitmask, steps the
env (auto-reset on done, viewer_app.cpp:56-66) and renders either the active
agent's view or a free overview camera (viewer.cpp:153-303 fly-cam) at
`--hires` times 128 x 72 through `env.render_custom_camera` (on the card,
the render kernel's form B1), returned as a PNG.

Controls:
  W/S          forward / backward
  A/D          strafe left / right
  Left/Right   look left / right
  Up/Down      look up / down
  Space        jump
  E            interact
  1..9 / Tab   switch active agent
  O            toggle overview fly-cam  (WASD+QZ move, IJKL look)

Usage:
  python scripts/viewer_app_torch.py --env TowerBuilding --num_agents 2 --port 8831

Runs on the card; `--device cpu` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import math
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402


PAGE = """<!doctype html>
<html><head><title>megaverse_tpu_torch viewer</title><style>
 body { background:#111; color:#ddd; font-family:monospace; text-align:center }
 canvas { image-rendering: pixelated; border:1px solid #444; margin-top:12px }
 #hud { margin-top:8px; white-space:pre }
</style></head><body>
<h3>megaverse_tpu_torch — %SCENARIO%</h3>
<canvas id="cv" width="%W%" height="%H%" style="width:%DW%px;height:%DH%px"></canvas>
<div id="hud">connecting…</div>
<script>
const keys = new Set();
window.addEventListener('keydown', e => { keys.add(e.code); e.preventDefault(); });
window.addEventListener('keyup',   e => { keys.delete(e.code); });
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
const hud = document.getElementById('hud');
let busy = false;
async function tick() {
  if (busy) return; busy = true;
  try {
    const r = await fetch('/step', {method:'POST',
      body: JSON.stringify({keys:[...keys]})});
    const j = await r.json();
    const img = new Image();
    img.onload = () => ctx.drawImage(img, 0, 0);
    img.src = 'data:image/png;base64,' + j.frame;
    hud.textContent = `agent ${j.agent}  reward ${j.reward.toFixed(3)}  ` +
      `total ${j.total_reward.toFixed(2)}  frame ${j.frame_no}` +
      (j.overview ? '  [overview]' : '') + (j.done ? '  EPISODE DONE' : '');
    for (const code of j.consumed) keys.delete(code);
  } finally { busy = false; }
}
setInterval(tick, 1000/15);
</script></body></html>
"""


class ViewerState:
    """One env + camera/agent-switch state behind a lock."""

    def __init__(self, scenario: str, num_agents: int, seed: int, hires: int,
                 device: str = "cuda", params=None):
        from megaverse_tpu_torch.rl.train import resolve_device
        from megaverse_tpu_torch.vector_env import VectorEnv

        self.env = VectorEnv(scenario, num_envs=1, num_agents_per_env=num_agents, seed=seed,
                             params=params, obs_format="rgb", device=resolve_device(device))
        self.scenario = scenario
        self.num_agents = num_agents
        self.hires = hires
        self.active_agent = 0
        self.overview = False
        self.total_reward = 0.0
        self.frame_no = 0
        self.lock = threading.Lock()
        self.env.reset()
        # overview fly-cam state (viewer.cpp:153-303)
        pos = self.env.state.agents.pos[0, 0].cpu().numpy()
        self.cam_eye = [float(pos[0]) - 4.0, float(pos[1]) + 6.0, float(pos[2]) + 6.0]
        self.cam_yaw = -0.6
        self.cam_pitch = -0.6

    # -- key decoding -------------------------------------------------------
    @staticmethod
    def _bitmask(keys) -> int:
        import megaverse_tpu_torch.constants as C

        k = set(keys)
        m = 0
        for code, bit in (("KeyW", C.ACTION_FORWARD), ("KeyS", C.ACTION_BACKWARD),
                          ("KeyA", C.ACTION_LEFT), ("KeyD", C.ACTION_RIGHT),
                          ("ArrowLeft", C.ACTION_LOOK_LEFT),
                          ("ArrowRight", C.ACTION_LOOK_RIGHT),
                          ("ArrowUp", C.ACTION_LOOK_UP), ("ArrowDown", C.ACTION_LOOK_DOWN),
                          ("Space", C.ACTION_JUMP), ("KeyE", C.ACTION_INTERACT)):
            if code in k:
                m |= bit
        return m

    def _fly_cam(self, keys):
        k = set(keys)
        speed, look = 0.35, 0.06
        cy, sy = math.cos(self.cam_yaw), math.sin(self.cam_yaw)
        fwd = (-sy, 0.0, -cy)  # same convention as agent forward
        right = (cy, 0.0, -sy)
        d = [0.0, 0.0, 0.0]
        for code, vec, sign in (("KeyW", fwd, 1), ("KeyS", fwd, -1),
                                ("KeyD", right, 1), ("KeyA", right, -1)):
            if code in k:
                d = [d[i] + sign * vec[i] for i in range(3)]
        if "KeyQ" in k:
            d[1] += 1.0
        if "KeyZ" in k:
            d[1] -= 1.0
        self.cam_eye = [self.cam_eye[i] + speed * d[i] for i in range(3)]
        if "KeyJ" in k:
            self.cam_yaw += look
        if "KeyL" in k:
            self.cam_yaw -= look
        if "KeyI" in k:
            self.cam_pitch = min(1.5, self.cam_pitch + look)
        if "KeyK" in k:
            self.cam_pitch = max(-1.5, self.cam_pitch - look)

    # -- one viewer tick ----------------------------------------------------
    def step(self, keys) -> dict:
        import megaverse_tpu_torch.constants as C
        from megaverse_tpu_torch.env import render_custom_camera

        consumed = []
        with self.lock:
            for code in list(keys):
                if code == "KeyO":
                    self.overview = not self.overview
                    consumed.append(code)
                elif code == "Tab":
                    self.active_agent = (self.active_agent + 1) % self.num_agents
                    consumed.append(code)
                elif code.startswith("Digit"):
                    idx = int(code[5:]) - 1
                    if 0 <= idx < self.num_agents:
                        self.active_agent = idx
                    consumed.append(code)

            act = np.zeros((1, self.num_agents), np.int32)
            if not self.overview:
                act[0, self.active_agent] = self._bitmask(keys)
            else:
                self._fly_cam(keys)

            _, rew, done, _ = self.env.step(act)
            self.frame_no += 1
            reward = float(rew[0, self.active_agent])
            self.total_reward += reward
            is_done = bool(done[0])
            if is_done:
                self.total_reward = 0.0

            if self.overview:
                eye, yaw, pitch = self.cam_eye, self.cam_yaw, self.cam_pitch
            else:
                ag = self.env.state.agents
                cam_y = C.AGENT_BODY_OFFSET_Y + C.AGENT_CAMERA_OFFSET_Y
                eye = ag.pos[0, self.active_agent].cpu().numpy() + np.asarray([0.0, cam_y, 0.0])
                yaw = float(ag.yaw[0, self.active_agent])
                pitch = float(ag.pitch[0, self.active_agent])
            img = render_custom_camera(self.env.scenario, self.env.state, eye, yaw, pitch,
                                       width=self.hires * 128,
                                       height=self.hires * 72).cpu().numpy()

        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        return {
            "frame": base64.b64encode(buf.getvalue()).decode(),
            "agent": self.active_agent,
            "reward": reward,
            "total_reward": self.total_reward,
            "done": is_done,
            "frame_no": self.frame_no,
            "overview": self.overview,
            "consumed": consumed,
        }


def make_handler(state: ViewerState, hires: int):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path != "/":
                self.send_response(404)
                self.end_headers()
                return
            page = (PAGE.replace("%SCENARIO%", state.scenario)
                    .replace("%W%", str(hires * 128)).replace("%H%", str(hires * 72))
                    .replace("%DW%", str(4 * 128)).replace("%DH%", str(4 * 72)))
            body = page.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            if self.path != "/step":
                self.send_response(404)
                self.end_headers()
                return
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            out = json.dumps(state.step(req.get("keys", []))).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--env", default="TowerBuilding")
    p.add_argument("--num_agents", type=int, default=1)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--port", type=int, default=8831)
    p.add_argument("--hires", type=int, default=2, help="render scale (x128 x72)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    args = p.parse_args(argv)

    state = ViewerState(args.env, args.num_agents, args.seed, args.hires, args.device)
    srv = ThreadingHTTPServer(("127.0.0.1", args.port), make_handler(state, args.hires))
    print(f"viewer: http://127.0.0.1:{args.port}/  (scenario={args.env})", flush=True)
    try:
        srv.serve_forever()
    finally:
        state.env.close()


if __name__ == "__main__":
    main()
