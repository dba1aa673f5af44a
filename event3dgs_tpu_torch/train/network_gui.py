"""Remote-viewer TCP server speaking the SIBR wire protocol.

Counterpart of ``event3dgs_tpu/train/network_gui.py``, wire-compatible
with the reference `gaussian_renderer/network_gui.py:26-86` (and hence the
upstream SIBR remote viewer): the client sends a 4-byte little-endian
length + JSON message carrying resolution, FoVs, near/far, flags, a
column-flipped view matrix and view-projection matrix; the server replies
with raw H×W×3 uint8 bytes followed by a length-prefixed verify string
(the source path).

The listener is non-blocking; the training loop polls it between
iterations through :meth:`NetworkGui.wrap_callbacks`, so rendering happens
in the training process, on the model's device, with the pipeline's
rasterizer (the ported kernels on the card).
"""

from __future__ import annotations

import json
import socket

import numpy as np
import torch


class NetworkGui:
    def __init__(self, host: str, port: int, state, data, cfg):
        self.host = host
        self.port = port
        self.state = state
        self.cfg = cfg
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.conn = None

    def start(self):
        self.listener.bind((self.host, self.port))
        self.listener.listen()
        self.listener.settimeout(0.0)
        print(f"GUI server listening on {self.host}:{self.port}")

    def stop(self):
        if self.conn is not None:
            self.conn.close()
        self.listener.close()

    # ------------------------------------------------------------- protocol

    def _read_message(self):
        length = int.from_bytes(self._recv_exact(4), "little")
        return json.loads(self._recv_exact(length).decode("utf-8"))

    def _recv_exact(self, n):
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("gui client closed")
            buf += chunk
        return buf

    def _send(self, image_bytes, verify: str):
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(verify.encode("ascii"))

    def _camera_from_message(self, msg):
        from event3dgs_tpu_torch.core.camera import Camera

        w, h = msg["resolution_x"], msg["resolution_y"]
        if w == 0 or h == 0:
            return None
        view = np.asarray(msg["view_matrix"], np.float32).reshape(4, 4)
        view[:, 1] *= -1
        view[:, 2] *= -1
        proj = np.asarray(msg["view_projection_matrix"], np.float32).reshape(4, 4)
        proj[:, 1] *= -1
        center = np.linalg.inv(view)[3, :3]
        dev = self.state.params.device

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        return Camera(
            world_view=f32(view),
            full_proj=f32(proj),
            camera_center=f32(center),
            tan_fovx=f32(np.tan(msg["fov_x"] / 2)),
            tan_fovy=f32(np.tan(msg["fov_y"] / 2)),
            width=int(w),
            height=int(h),
            znear=float(msg["z_near"]),
            zfar=float(msg["z_far"]),
        )

    # ----------------------------------------------------------------- hook

    def poll(self, state):
        """Service one round of GUI traffic; called between train steps."""
        self.state = state
        if self.conn is None:
            try:
                self.conn, addr = self.listener.accept()
                self.conn.settimeout(None)
                print(f"\nGUI connected by {addr}")
            except (BlockingIOError, OSError):
                return
        try:
            msg = self._read_message()
            cam = self._camera_from_message(msg)
            img_bytes = None
            if cam is not None:
                img_bytes = self._render_for_gui(cam, msg)
            self._send(img_bytes, self.cfg.model.source_path)
        except (ConnectionError, OSError, json.JSONDecodeError):
            self.conn = None

    @torch.no_grad()
    def _render_for_gui(self, cam, msg):
        from event3dgs_tpu_torch.losses.basic import rgb_to_grayscale
        from event3dgs_tpu_torch.models import activated
        from event3dgs_tpu_torch.ops import render

        act = activated(self.state.params)
        out = render(
            act.means3d, act.features, act.opacities, act.scales,
            act.rotations, cam, torch.zeros(3, device=act.means3d.device),
            sh_degree=self.state.max_sh_degree,
            scaling_modifier=float(msg.get("scaling_modifier", 1.0)),
            rasterizer=self.cfg.pipeline.rasterizer,
        )
        img = torch.clamp(out.image, 0.0, 1.0)
        if self.cfg.model.gray:
            img = rgb_to_grayscale(img).expand(-1, -1, 3)
        return (img * 255.0).to(torch.uint8).cpu().numpy().tobytes()

    def wrap_callbacks(self, callbacks):
        """Chain GUI polling onto the loop's callbacks.

        The reference polls the socket every iteration (`train.py:76-93`);
        here the tick callback (every ``log_every`` iterations) services the
        GUI without a per-iteration host sync, and saves poll too so a
        connected viewer refreshes at checkpoints.
        """
        prev_tick = callbacks.on_tick

        def on_tick(it, state):
            self.poll(state)
            if prev_tick:
                prev_tick(it, state)

        callbacks.on_tick = on_tick
        prev_save = callbacks.on_save

        def on_save(it, state):
            self.poll(state)
            if prev_save:
                prev_save(it, state)

        callbacks.on_save = on_save
        return callbacks
