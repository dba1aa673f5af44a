"""The event slice end to end against the JAX package, on the CPU: the
port's simulator and frame functions fed the JAX package's rendered chain,
``render_event_set``, and ``cli.render --event`` on the tiny Blender scene
of ``test_torch_render``.

Renders of the two packages differ by float32 ulps, which can move a
pixel's log intensity across a contrast threshold.  With the default sensor
(threshold noise and latency jitter drawn from one numpy generator) one
extra or missing crossing shifts every later draw of the generator, so the
two streams' timestamps part after the first flip while their pixels and
polarities stay close.  The end-to-end streams are therefore held to:
event counts within 1 %, and at least 97 % of the events' (x, y, p) shared
as multisets (98.7 % and 100 % measured on this scene); in deterministic
mode (no draws), at least 98 % of the (t, x, y, p) events shared (99.2 %
measured).  Fed the same frames, the streams are byte-equal.
"""

import os
import shutil
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from event3dgs_tpu.cli.render import main as jrender_main
from event3dgs_tpu.data import scene as jscene
from event3dgs_tpu.events import dvs_model as jdvs
from event3dgs_tpu.events import simulate as jsim
from event3dgs_tpu.tools import render_products as jprod
from event3dgs_tpu_torch.cli.render import main as trender_main
from event3dgs_tpu_torch.data import scene as tscene
from event3dgs_tpu_torch.events import buffer as tbuf
from event3dgs_tpu_torch.events import dvs_model as tdvs
from event3dgs_tpu_torch.events import simulate as tsim
from event3dgs_tpu_torch.events.io import load_dat_events
from event3dgs_tpu_torch.tools import render_products as tprod
from test_torch_events import assert_same_pngs, assert_streams_equal, pngs
from test_torch_render import ITER, H, W, tiny_scene, to_port  # noqa: F401

torch.set_num_threads(1)


def jax_chain(src, params, steps):
    """The JAX package's interpolated chain of the tiny scene, rendered
    (float frames in [0, 1], as ``render_event_set`` feeds the DVS)."""
    infos = jscene.read_blender_scene(str(src)).train_cameras
    cams, _ = jprod.interpolated_cameras(infos, steps, W, H)
    return [np.clip(np.asarray(jprod._render_view(params, c, 3, jnp.zeros(3),
                                                  "reference")), 0, 1)
            for c in cams]


def test_port_simulation_of_jax_frames_is_byte_equal(tiny_scene, tmp_path):
    src, _, params = tiny_scene
    frames = jax_chain(src, params, 3)
    out = {}
    for name, msim, kw in (("jax", jsim, {}), ("torch", tsim, {"device": "cpu"})):
        buf = msim.simulate_event_camera(frames, dt=1000.0)
        d = str(tmp_path / name)
        msim.save_event_result(buf, d, width=W, height=H)
        imgs = msim.generate_event_frames(buf, W, H, 3000,
                                          out_dir=os.path.join(d, "frames"), **kw)
        out[name] = (buf, imgs)
    assert len(out["jax"][0]) > 1000
    assert_streams_equal(out["torch"][0], out["jax"][0])
    assert ((tmp_path / "jax" / "raw.dat").read_bytes()
            == (tmp_path / "torch" / "raw.dat").read_bytes())
    assert len(out["torch"][1]) == len(out["jax"][1]) > 0
    for a, b in zip(out["jax"][1], out["torch"][1]):
        np.testing.assert_array_equal(b, a)
    assert_same_pngs(tmp_path / "jax", tmp_path / "torch")


def shared(a, b, fields):
    """Share of events common to streams ``a`` and ``b`` (as multisets of
    the named fields) over the larger stream."""
    key = lambda s: Counter(zip(*(s[f].tolist() for f in fields)))
    n = max(len(a), len(b))
    return sum((key(a) & key(b)).values()) / n


def check_stream(ev):
    assert len(ev) > 0
    assert (np.diff(ev["t"].astype(np.int64)) >= 0).all()
    assert ev["x"].max() < W and ev["y"].max() < H


def test_render_event_set_matches_jax_deterministic(tiny_scene, tmp_path):
    """Both packages' ``render_event_set`` with a deterministic sensor: the
    renders within 1 LSB and at least 98 % of (t, x, y, p) shared."""
    src, _, params = tiny_scene
    jinfos = jscene.read_blender_scene(str(src)).train_cameras
    tinfos = tscene.read_blender_scene(str(src)).train_cameras
    bufs = [
        jprod.render_event_set(params, jinfos, str(tmp_path / "jax"), W, H, 3,
                               interpolation=3, dt=1000.0,
                               dvs_params=jdvs.DvsParams(th_noise=0, jitter=0),
                               rasterizer="tiled"),
        tprod.render_event_set(to_port(params), tinfos, str(tmp_path / "torch"),
                               W, H, 3, interpolation=3, dt=1000.0,
                               dvs_params=tdvs.DvsParams(th_noise=0, jitter=0),
                               rasterizer="tiled"),
    ]
    a, b = (buf.to_structured() for buf in bufs)
    check_stream(b)
    assert shared(a, b, ("t", "x", "y", "p")) >= 0.98
    renders = [sorted(f for f in os.listdir(tmp_path / n) if f.endswith(".png"))
               for n in ("jax", "torch")]
    assert renders[0] == renders[1] == [f"render_{i:05d}.png" for i in range(4)]
    for f in renders[0]:
        ja = np.asarray(Image.open(tmp_path / "jax" / f), np.int16)
        tb = np.asarray(Image.open(tmp_path / "torch" / f), np.int16)
        assert np.abs(ja - tb).max() <= 1, f


@pytest.mark.parametrize("steps,dt", [(3, 1000.0), (2, 500.0)])
def test_cli_render_event_matches_jax(tiny_scene, steps, dt):
    """``cli.render --event`` of both packages on the same model: the JAX
    CLI's layout, ``render_*.png`` within 1 LSB, the ``raw.dat`` header
    and the frame names equal, and the streams within the tolerance the
    module docstring states."""
    _, models, _ = tiny_scene
    rel = os.path.join("train", f"ours_{ITER}", "event")
    dirs = [models[n] / rel for n in ("jax", "torch")]
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)
    args = ["--skip_train", "--skip_test", "--event", "--interpolationN",
            str(steps), "--dt", str(dt)]
    assert jrender_main(["-m", str(models["jax"]), *args]) == 0
    assert trender_main(["-m", str(models["torch"]), *args, "--device", "cpu"]) == 0
    names = [sorted(os.listdir(d)) for d in dirs]
    n_views = 2
    want = sorted([f"render_{i:05d}.png" for i in range((n_views - 1) * steps + 1)]
                  + ["frames", "raw.dat"])
    assert names[0] == names[1] == want
    for f in want:
        if f.startswith("render_"):
            ja = np.asarray(Image.open(dirs[0] / f), np.int16)
            tb = np.asarray(Image.open(dirs[1] / f), np.int16)
            assert np.abs(ja - tb).max() <= 1, f
    heads = [(d / "raw.dat").read_bytes().split(b"\x00\x08")[0] for d in dirs]
    assert heads[0] == heads[1] and f"% Width {W}\n".encode() in heads[0]
    streams = []
    for d in dirs:
        t, x, y, p = load_dat_events(str(d / "raw.dat"))
        streams.append(tbuf.EventBuffer.from_arrays(t, x, y, p).to_structured())
    a, b = streams
    check_stream(b)
    assert abs(len(a) - len(b)) <= 0.01 * len(a)
    assert shared(a, b, ("x", "y", "p")) >= 0.97
    frames = [pngs(d / "frames") for d in dirs]
    assert sorted(frames[0]) == sorted(frames[1]) and frames[0]
