"""The port's SIBR viewer server and ``cli.train``'s TensorBoard scalars.

- ``train/network_gui.NetworkGui`` against the JAX one, driven by the fake
  SIBR client of tests/test_checkpoint_gui.py: the same verify string,
  image bytes within one 8-bit level, the verify string alone for a
  zero-resolution message;
- ``cli.train --port`` on a tiny scene serving that client while it trains;
- the JAX package's scalars (``train_loss_patches/total_loss``,
  ``train_loss_patches/l1_loss``, ``event/contrast``, ``total_points``)
  in the run's event file, and the JAX message when
  ``torch.utils.tensorboard`` cannot be imported.
"""

import json
import socket
import sys
import threading
import time

import numpy as np
import pytest
import torch

from event3dgs_tpu.core.camera import make_camera as jmake_camera
from event3dgs_tpu.models import init_from_point_cloud as jinit
from event3dgs_tpu.train import init_train_state as jinit_state
from event3dgs_tpu.train.network_gui import NetworkGui as JNetworkGui
from event3dgs_tpu.utils.config import TrainConfig as JTrainConfig
from event3dgs_tpu_torch.cli import train as ttrain
from event3dgs_tpu_torch.models import init_from_point_cloud
from event3dgs_tpu_torch.tools.make_scene import synthesize_scene
from event3dgs_tpu_torch.train import init_train_state
from event3dgs_tpu_torch.train.network_gui import NetworkGui
from event3dgs_tpu_torch.utils.config import TrainConfig

torch.set_num_threads(1)

W, H = 48, 32


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("server closed")
        buf += chunk
    return buf


def sibr_message(w=W, h=H):
    """The SIBR client's request: view/projection columns 1 and 2 negated
    (reference network_gui.py:74-77 undoes it on the server)."""
    fovx, fovy = 1.0, 0.8
    cam = jmake_camera(np.eye(3), np.asarray([0.0, 0.0, 4.0]), fovx, fovy,
                       max(w, 1), max(h, 1))
    view = np.asarray(cam.world_view, np.float64).copy()
    view[:, 1] *= -1
    view[:, 2] *= -1
    proj = np.asarray(cam.full_proj, np.float64).copy()
    proj[:, 1] *= -1
    proj[:, 2] *= -1
    msg = {
        "resolution_x": w, "resolution_y": h, "train": True, "fov_y": fovy,
        "fov_x": fovx, "z_near": 0.01, "z_far": 100.0, "shs_python": False,
        "rot_scale_python": False, "keep_alive": True,
        "scaling_modifier": 1.0, "view_matrix": view.reshape(-1).tolist(),
        "view_projection_matrix": proj.reshape(-1).tolist(),
    }
    payload = json.dumps(msg).encode("utf-8")
    return len(payload).to_bytes(4, "little") + payload


def read_reply(client, with_image=True):
    img = recv_exact(client, W * H * 3) if with_image else None
    vlen = int.from_bytes(recv_exact(client, 4), "little")
    return img, recv_exact(client, vlen).decode("ascii")


def serve_once(gui, state, messages):
    """Send each message, let the server poll once, read each reply."""
    port = gui.port
    gui.start()
    replies = []
    try:
        client = socket.create_connection(("127.0.0.1", port), timeout=30)
        try:
            for msg, with_image in messages:
                client.sendall(msg)
                gui.poll(state)
                replies.append(read_reply(client, with_image))
        finally:
            client.close()
    finally:
        gui.stop()
    return replies


def test_network_gui_matches_jax():
    rng = np.random.default_rng(3)
    pts = rng.normal(0, 0.5, (40, 3))
    cols = rng.uniform(0.1, 1.0, (40, 3))
    msgs = [(sibr_message(), True), (sibr_message(0, 0), False)]
    out = {}
    for name, cfg_cls, gui_cls, state in (
            ("jax", JTrainConfig, JNetworkGui,
             jinit_state(jinit(pts, cols, 48), 1.0)),
            ("torch", TrainConfig, NetworkGui, init_train_state(
                init_from_point_cloud(pts, cols, 48, device="cpu"), 1.0))):
        cfg = cfg_cls()
        cfg.model.source_path = "/data/test_scene"
        cfg.model.gray = True
        out[name] = serve_once(gui_cls("127.0.0.1", free_port(), state, None,
                                       cfg), state, msgs)
    (jimg, jver), (_, jver0) = out["jax"]
    (timg, tver), (none, tver0) = out["torch"]
    assert tver == jver == tver0 == jver0 == "/data/test_scene"
    assert none is None
    a = np.frombuffer(timg, np.uint8).astype(int)
    b = np.frombuffer(jimg, np.uint8).astype(int)
    assert a.max() > 0 and np.abs(a - b).max() <= 1
    # gray mode: the three channels repeat the luma
    px = a.reshape(H, W, 3)
    assert (px[..., 0] == px[..., 1]).all() and (px[..., 1] == px[..., 2]).all()


@pytest.fixture(scope="module")
def tiny_scene(tmp_path_factory):
    src = tmp_path_factory.mktemp("tiny") / "scene"
    synthesize_scene(str(src), n_views=8, width=48, height=48,
                     n_gaussians=60, white_background=True, device="cpu")
    return src


def train_args(src, model, iters, *extra, saves=()):
    return ["-s", str(src), "-m", str(model), "--gray", "--event", "-r", "1",
            "-w", "--iterations", str(iters), "--densify_from_iter", "10000",
            "--save_iterations", *[str(i) for i in (*saves, iters)],
            "--checkpoint_iterations", str(iters), "--device", "cpu", *extra]


def test_cli_train_port_serves_viewer(tiny_scene, tmp_path, capsys):
    port = free_port()
    got = {}

    def client():
        deadline = time.time() + 120
        while time.time() < deadline:
            try:
                sock = socket.create_connection(("127.0.0.1", port), timeout=60)
                break
            except OSError:
                time.sleep(0.005)
        else:
            return
        with sock:
            sock.sendall(sibr_message())
            got["reply"] = read_reply(sock)

    t = threading.Thread(target=client)
    t.start()
    try:
        # the server polls at every save
        rc = ttrain.main(train_args(tiny_scene, tmp_path / "model", 6,
                                    "--port", str(port), saves=range(1, 6)))
    finally:
        t.join(timeout=120)
    assert rc == 0 and not t.is_alive()
    img, verify = got["reply"]
    assert verify == str(tiny_scene)
    assert len(img) == W * H * 3 and max(img) > 0
    out = capsys.readouterr().out
    assert f"GUI server listening on 127.0.0.1:{port}" in out
    assert "GUI connected by" in out


def test_tensorboard_scalars_written(tiny_scene, tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    model = tmp_path / "model"
    assert ttrain.main(train_args(tiny_scene, model, 100, "--quiet")) == 0
    acc = EventAccumulator(str(model))
    acc.Reload()
    tags = set(acc.Tags()["scalars"])
    assert tags == {"train_loss_patches/total_loss",
                    "train_loss_patches/l1_loss", "event/contrast",
                    "total_points"}
    loss = acc.Scalars("train_loss_patches/total_loss")
    assert [e.step for e in loss] == [100] and np.isfinite(loss[0].value)
    assert acc.Scalars("total_points")[0].value > 0


def test_tensorboard_missing_prints_jax_message(tiny_scene, tmp_path, capsys,
                                                monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    assert ttrain.main(train_args(tiny_scene, tmp_path / "model", 1)) == 0
    out = capsys.readouterr().out
    assert "Tensorboard not available: not logging progress" in out
    assert not list((tmp_path / "model").glob("events.out.tfevents*"))
