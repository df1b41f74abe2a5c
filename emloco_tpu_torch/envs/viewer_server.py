"""Live interactive viewer served over HTTP, headless-safe (port of
emloco_tpu/envs/viewer_server.py).

The counterpart of the reference's Isaac Gym viewer loop and server mode
(base_task.py:135-211 camera and keyboard, :351-430 event handling): a
small HTTP server streams rendered frames and maps each reference keyboard
action to a POST /control command —

    reference key (base_task.py)        /control cmd
    SPACE "PAUSE"            (:187)  →  pause / resume
    R     "reset"            (:170)  →  reset
    J     "apply_force"      (:401-410) → push  (velocity kick on the focus
                                          env's root)
    F     "follow"           (:171,379) → follow (camera tracks the root)
    K     "show_traj"        (:178,398) → show_traj
    LEFT/RIGHT prev/next_env (:180-181,412-419) → prev_env / next_env / env

The sim advances in chunks of `chunk_steps` eager control steps on the
session's device (observe → `agent._policy` → the mean when deterministic →
`env.step`, every draw from the session's generator), with controls applied
between chunks, the reference's cadence of one poll per env step. On the
card each control step launches the block-arrow factor once and the resolve
once per substep. Frames are rendered with matplotlib, imported inside
`render_png`; without it /frame.png answers with the error reply.
"""
from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

_PAGE = """<!doctype html>
<html><head><title>emloco_tpu_torch viewer</title></head>
<body style="font-family:sans-serif;background:#111;color:#eee">
<h3>emloco_tpu_torch live viewer</h3>
<img id="frame" src="/frame.png" width="560"/>
<pre id="status"></pre>
<div>
<button onclick="ctl('pause')">pause</button>
<button onclick="ctl('resume')">resume</button>
<button onclick="ctl('reset')">reset</button>
<button onclick="ctl('push')">push</button>
<button onclick="ctl('follow')">follow</button>
<button onclick="ctl('show_traj')">traj</button>
<button onclick="ctl('prev_env')">&larr; env</button>
<button onclick="ctl('next_env')">env &rarr;</button>
</div>
<script>
function ctl(cmd){fetch('/control',{method:'POST',body:JSON.stringify({cmd:cmd})});}
setInterval(function(){
  document.getElementById('frame').src='/frame.png?t='+Date.now();
  fetch('/status').then(r=>r.json()).then(
    s=>document.getElementById('status').textContent=JSON.stringify(s));
}, 500);
</script></body></html>"""


class ViewerSession:
    """Owns the env state and the chunk step; thread-safe controls.

    `agent` is an AMPAgent (or anything exposing .env and ._policy with the
    same signature); `ts` a TrainState whose params drive the policy (its
    env state is copied, generator included, so the session leaves `ts` as
    it was). With deterministic=True the policy mean is used (the reference
    player's is_determenistic flag, amp_players.py).
    """

    def __init__(self, agent, ts, chunk_steps: int = 4,
                 deterministic: bool = True, seed: int = 0,
                 push_velocity=(-2.0, 0.0)):
        self.agent = agent
        self.ts = ts
        dev = agent.env.device
        rng = torch.Generator(device=dev)
        rng.set_state(ts.env_state.rng.get_state())
        self.state = ts.env_state.replace(rng=rng)
        self.env_index = 0          # reference viewing_env_idx
        self.paused = False
        self.follow = True          # reference flags.follow
        self.show_traj = True       # reference flags.show_traj
        self.step_count = 0
        self.last_reward = 0.0
        self.last_error = None
        self.push_velocity = push_velocity
        self.chunk_steps = int(chunk_steps)
        self.deterministic = deterministic
        self._lock = threading.Lock()
        self._gen = torch.Generator(device=dev).manual_seed(seed)

    @torch.no_grad()
    def _chunk(self):
        env, agent = self.agent.env, self.agent
        state = self.state
        for _ in range(self.chunk_steps):
            obs = env.observe(state)
            a, mu, *_ = agent._policy(self.ts.params, self.ts.obs_norm, obs,
                                      self._gen)
            state, out = env.step(state, mu if self.deterministic else a)
        return state, out.reward

    # -- sim advance ------------------------------------------------------

    def step_chunk(self):
        """Advance one chunk unless paused. Returns True if the sim
        advanced."""
        with self._lock:
            if self.paused:
                return False
            self.state, rew = self._chunk()
            self.step_count += self.chunk_steps
            self.last_reward = float(rew[self.env_index])
            return True

    # -- controls (reference keyboard actions, base_task.py:351-430) ------

    def control(self, cmd: str, **kw):
        with self._lock:
            n = self.state.physics.num_envs
            if cmd == "pause":
                self.paused = True
            elif cmd == "resume":
                self.paused = False
            elif cmd == "reset":                       # KEY_R
                seed = int(torch.randint(2 ** 62, (1,), generator=self._gen,
                                         device=self._gen.device))
                env = self.agent.env
                self.state = env.reset(
                    torch.Generator(device=env.device).manual_seed(seed))
                self.step_count = 0
            elif cmd == "push":                        # KEY_J apply_force
                ph = self.state.physics
                dv = torch.as_tensor(kw.get("velocity", self.push_velocity),
                                     dtype=ph.u.dtype, device=ph.u.device)
                u = ph.u.clone()
                u[self.env_index, 0:2] += dv[:2]
                self.state = self.state.replace(physics=ph.replace(u=u))
            elif cmd == "follow":                      # KEY_F
                self.follow = not self.follow
            elif cmd == "show_traj":                   # KEY_K
                self.show_traj = not self.show_traj
            elif cmd == "prev_env":                    # KEY_LEFT
                self.env_index = (self.env_index - 1) % n
            elif cmd == "next_env":                    # KEY_RIGHT
                self.env_index = (self.env_index + 1) % n
            elif cmd == "env":
                self.env_index = int(kw.get("index", 0)) % n
            else:
                raise ValueError(f"unknown viewer command: {cmd}")
        return self.status()

    # -- rendering --------------------------------------------------------

    def render_png(self) -> bytes:
        """Render the focus env's current frame to PNG bytes (the viewer
        camera; follow mode centers on the root like viewer_camera_look_at).

        Builds a Figure directly on an Agg canvas — pyplot's Gcf registry is
        global, not thread-safe, and ThreadingHTTPServer serves concurrent
        /frame.png requests."""
        from matplotlib.backends.backend_agg import FigureCanvasAgg
        from matplotlib.figure import Figure

        from ..kinematics.visualization import plot_skeleton_state
        from ..physics import body_frame_state

        with self._lock:
            state = self.state
            idx = self.env_index
            show_traj = self.show_traj
            follow = self.follow
            step = self.step_count
            rew = self.last_reward
        pos, _, _, _ = body_frame_state(self.agent.env.model, state.physics)
        joints = pos[idx].cpu().numpy()                    # (24, 3)
        traj = state.traj_verts[idx].cpu().numpy()

        fig = Figure(figsize=(5, 5))
        FigureCanvasAgg(fig)
        ax = fig.add_subplot(111, projection="3d")
        if show_traj:
            ax.plot(traj[:, 0], traj[:, 1], traj[:, 2] * 0,
                    color="tab:red", linewidth=1, alpha=0.6)
        plot_skeleton_state(ax, joints)
        c = joints[0] if follow else np.zeros(3)
        ax.set_xlim(c[0] - 2, c[0] + 2)
        ax.set_ylim(c[1] - 2, c[1] + 2)
        ax.set_zlim(0, 2.2)
        ax.set_title(f"env {idx}  t={step}  r={rew:+.3f}", fontsize=9)
        buf = io.BytesIO()
        fig.savefig(buf, format="png", dpi=100)
        return buf.getvalue()

    def status(self) -> dict:
        return {
            "step": self.step_count,
            "env": self.env_index,
            "num_envs": int(self.state.physics.num_envs),
            "reward": self.last_reward,
            "paused": self.paused,
            "follow": self.follow,
            "show_traj": self.show_traj,
            "last_error": self.last_error,
        }


class ViewerServer:
    """HTTP front-end over a ViewerSession + a paced background sim loop."""

    def __init__(self, session: ViewerSession, host: str = "127.0.0.1",
                 port: int = 8703, fps: float = 10.0):
        self.session = session
        self.fps = max(fps, 0.1)
        self._stop = threading.Event()
        sess = session

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, code, payload, ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                path = self.path.split("?")[0]
                try:
                    if path == "/":
                        self._reply(200, _PAGE.encode(), "text/html")
                    elif path == "/frame.png":
                        self._reply(200, sess.render_png(), "image/png")
                    elif path == "/status":
                        self._reply(200, json.dumps(sess.status()).encode())
                    else:
                        self._reply(404, b'{"error": "not found"}')
                except Exception as e:  # keep serving after a bad render
                    try:
                        self._reply(500,
                                    json.dumps({"error": str(e)}).encode())
                    except Exception:
                        pass

            def do_POST(self):
                if self.path.split("?")[0] != "/control":
                    self._reply(404, b'{"error": "not found"}')
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(n) or b"{}")
                    cmd = body.pop("cmd")
                    out = sess.control(cmd, **body)
                    self._reply(200, json.dumps(out).encode())
                except Exception as e:  # bad command → 400, keep serving
                    self._reply(400, json.dumps({"error": str(e)}).encode())

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)
        self._sim_thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self):
        period = 1.0 / self.fps
        while not self._stop.is_set():
            t0 = time.time()
            try:
                self.session.step_chunk()
                self.session.last_error = None
            except Exception as e:
                # an error in a chunk must not kill the sim thread: it
                # shows in /status and the next tick tries again
                self.session.last_error = str(e)
            dt = time.time() - t0
            if dt < period:
                self._stop.wait(period - dt)

    def start(self):
        self._http_thread.start()
        self._sim_thread.start()
        return self

    def close(self):
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._sim_thread.is_alive():
            self._sim_thread.join(timeout=10)
