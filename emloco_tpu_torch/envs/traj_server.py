"""Interactive trajectory input server (port of
emloco_tpu/envs/traj_server.py).

The sim process accepts new target trajectories over HTTP at runtime (the
reference's server mode, TrajGenerator.input_new_trajs). Standard library
only (http.server), thread-backed; the sim thread drains the queue between
steps and writes the trajectories into the device-resident real-path bank
in place (`update_traj_bank`) — the step itself never blocks.

Protocol:
    POST /trajs   body: JSON [[ [x,y], ... 101 pts ], ...]  → {"accepted": k}
    GET  /status  → {"pending": n, "received_total": m}
"""
from __future__ import annotations

import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch


class TrajInputServer:
    """Background HTTP server collecting trajectory submissions."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8702,
                 num_verts: int = 101):
        self.num_verts = num_verts
        self._queue: "queue.Queue[np.ndarray]" = queue.Queue()
        self._received = 0
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # silence request logging
                pass

            def _reply(self, code, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/status":
                    self._reply(200, {"pending": outer._queue.qsize(),
                                      "received_total": outer._received})
                else:
                    self._reply(404, {"error": "unknown path"})

            def do_POST(self):
                if self.path != "/trajs":
                    self._reply(404, {"error": "unknown path"})
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    data = json.loads(self.rfile.read(n))
                    k = outer.submit(data)
                    self._reply(200, {"accepted": k})
                except (ValueError, KeyError) as e:
                    self._reply(400, {"error": str(e)})

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def submit(self, trajs) -> int:
        """Accept a list of trajectories (each (V,2) points); trajectories of
        any length are resampled to num_verts by linear interpolation (the
        reference splines 13 → 101 the same way on ingest)."""
        arr = [np.asarray(t, np.float32) for t in trajs]
        k = 0
        for t in arr:
            if t.ndim != 2 or t.shape[1] != 2 or len(t) < 2:
                raise ValueError(f"trajectory must be (V>=2, 2), got {t.shape}")
            if len(t) != self.num_verts:
                s = np.linspace(0, len(t) - 1, self.num_verts)
                i0 = np.clip(s.astype(int), 0, len(t) - 2)
                f = (s - i0)[:, None]
                t = (1 - f) * t[i0] + f * t[i0 + 1]
            self._queue.put(t.astype(np.float32))
            self._received += 1
            k += 1
        return k

    def drain(self, max_items: Optional[int] = None) -> np.ndarray:
        """Pop pending trajectories → (K, V, 2) array (K may be 0)."""
        out = []
        while not self._queue.empty():
            if max_items is not None and len(out) >= max_items:
                break
            try:
                out.append(self._queue.get_nowait())
            except queue.Empty:
                break
        if not out:
            return np.zeros((0, self.num_verts, 2), np.float32)
        return np.stack(out)

    def close(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=2.0)


def update_traj_bank(bank: torch.Tensor, new_trajs: np.ndarray,
                     start: int = 0):
    """Write freshly submitted trajectories (K, V, >=2) into the real-path
    bank (P, V, 2) in place, as a ring from row `start`. Returns (the bank,
    the next start)."""
    k = len(new_trajs)
    if k == 0:
        return bank, start
    P = bank.shape[0]
    idx = torch.as_tensor((start + np.arange(k)) % P, device=bank.device)
    bank[idx] = torch.as_tensor(np.asarray(new_trajs)[:, :, :2],
                                dtype=bank.dtype, device=bank.device)
    return bank, int((start + k) % P)
