"""The port's event subsystem against the JAX package's, on the CPU: the
event buffer and codecs (``.dat`` bytes both ways), windowing and the
IEBCS reader, the DVS pixel model (bit-equal streams and voltages with and
without noise), ESIM, the arbiters, the stream metrics, accumulation
(exact, with repeated pixels and wrapped or dropped ``x``), colorimetry and
the frame layouts of ``generate_event_frames``."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from event3dgs_tpu.events import accumulate as jacc
from event3dgs_tpu.events import arbiter as jarb
from event3dgs_tpu.events import buffer as jbuf
from event3dgs_tpu.events import display as jdisp
from event3dgs_tpu.events import dvs_model as jdvs
from event3dgs_tpu.events import esim as jesim
from event3dgs_tpu.events import exr as jexr
from event3dgs_tpu.events import io as jio
from event3dgs_tpu.events import metrics as jmet
from event3dgs_tpu.events import simulate as jsim
from event3dgs_tpu.utils import colorimetry as jcol
from event3dgs_tpu_torch.events import accumulate as tacc
from event3dgs_tpu_torch.events import arbiter as tarb
from event3dgs_tpu_torch.events import buffer as tbuf
from event3dgs_tpu_torch.events import display as tdisp
from event3dgs_tpu_torch.events import dvs_model as tdvs
from event3dgs_tpu_torch.events import esim as tesim
from event3dgs_tpu_torch.events import exr as texr
from event3dgs_tpu_torch.events import io as tio
from event3dgs_tpu_torch.events import metrics as tmet
from event3dgs_tpu_torch.events import simulate as tsim
from event3dgs_tpu_torch.utils import colorimetry as tcol

torch.set_num_threads(1)

W, H = 64, 48


def random_stream(seed, n=2000, width=W, height=H, t_max=50_000):
    """A time-sorted stream (t u64, x u16, y u16, p u8) from ``seed``."""
    rng = np.random.default_rng(seed)
    return (np.sort(rng.integers(0, t_max, n)).astype(np.uint64),
            rng.integers(0, width, n).astype(np.uint16),
            rng.integers(0, height, n).astype(np.uint16),
            rng.integers(0, 2, n).astype(np.uint8))


def assert_streams_equal(a, b):
    """Two streams (tuples of arrays or EventBuffers) equal, dtypes too."""
    a = a.arrays() if hasattr(a, "arrays") else a
    b = b.arrays() if hasattr(b, "arrays") else b
    assert len(a) == len(b)
    for u, v in zip(a, b):
        assert np.asarray(u).dtype == np.asarray(v).dtype
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def luminance_frames(seed, n=5, width=W, height=H):
    rng = np.random.default_rng(seed)
    frames = [rng.uniform(40, 220, (height, width))]
    for _ in range(n - 1):
        frames.append(frames[-1] * rng.uniform(0.7, 1.4, (height, width)))
    return frames


# ---- buffer and codecs -----------------------------------------------------

def test_event_buffer_matches():
    t, x, y, p = random_stream(0, n=300)
    bufs = []
    for mod in (jbuf, tbuf):
        b = mod.EventBuffer(2)
        for i in range(5):
            b.add(int(t[i]), int(x[i]), int(y[i]), int(p[i]))
        b.add_array(t[200:], x[200:], y[200:], p[200:])
        b.merge(mod.EventBuffer.from_arrays(t[5:200], x[5:200], y[5:200],
                                            p[5:200]))
        bufs.append(b)
    assert len(bufs[0]) == len(bufs[1]) == 300
    assert bufs[0].capacity == bufs[1].capacity
    assert_streams_equal(*bufs)
    np.testing.assert_array_equal(bufs[1].to_structured(), bufs[0].to_structured())
    assert tbuf.EVENT_DTYPE == jbuf.EVENT_DTYPE


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("size", ["given", "inferred", "empty"])
def test_dat_files_are_byte_identical_and_read_both_ways(tmp_path, writer, size):
    t, x, y, p = random_stream(1, n=0 if size == "empty" else 700,
                               width=1920, height=1080, t_max=2_000_000)
    wh = dict(width=1920, height=1080) if size == "given" else {}
    paths = {}
    for name, mod in (("jax", jbuf), ("torch", tbuf)):
        paths[name] = str(tmp_path / f"{name}.dat")
        mod.EventBuffer.from_arrays(t, x, y, p).write_dat(paths[name], **wh)
    with open(paths["jax"], "rb") as a, open(paths["torch"], "rb") as b:
        assert a.read() == b.read()
    reader = tio if writer == "jax" else jio
    assert_streams_equal(reader.load_dat_events(paths[writer]), (t, x, y, p))
    for start, stop in ((0, -1), (500_000, -1), (300_000, 1_200_000)):
        assert_streams_equal(tio.load_dat_events(paths[writer], start, stop),
                             jio.load_dat_events(paths[writer], start, stop))


def test_dat_v1_and_field_width_errors(tmp_path):
    t, x, y, p = random_stream(2, n=200, width=500, height=500)
    packed = (x.astype(np.uint32) | (y.astype(np.uint32) << 9)
              | (p.astype(np.uint32) << 17))
    inter = np.empty(2 * len(t), np.uint32)
    inter[0::2], inter[1::2] = t.astype(np.uint32), packed
    path = tmp_path / "v1.dat"
    path.write_bytes(b"% Version 1\n% Width 500\n" + bytes([0, 8]) + inter.tobytes())
    assert_streams_equal(tio.load_dat_events(str(path)), jio.load_dat_events(str(path)))
    for mod in (jio, tio):
        with pytest.raises(ValueError, match="field widths"):
            mod.write_dat_events(str(tmp_path / "bad.dat"), [0], [2048], [0], [0])


def test_csv_h5_and_text_codecs_match(tmp_path):
    t, x, y, p = random_stream(3, n=150)
    for name, mod in (("jax", jbuf), ("torch", tbuf)):
        buf = mod.EventBuffer.from_arrays(t, x, y, p)
        buf.write_csv(str(tmp_path / f"{name}.csv"))
        buf.write_h5(str(tmp_path / f"{name}.h5"))
    assert (tmp_path / "jax.csv").read_bytes() == (tmp_path / "torch.csv").read_bytes()
    for ext, fn in (("csv", "load_csv_events"), ("h5", "load_h5_events")):
        for name in ("jax", "torch"):
            path = str(tmp_path / f"{name}.{ext}")
            assert_streams_equal(getattr(tio, fn)(path), getattr(jio, fn)(path))
    text = tmp_path / "ev.txt"
    text.write_text("# header\n(width 10 height 8)\n" + "".join(
        f"{i * 0.00037:.6f} {i % 10} {i % 8} {i % 2}\n" for i in range(60)))
    for scale in (1.0, 1e6):
        assert_streams_equal(tio.load_text_events(str(text), scale),
                             jio.load_text_events(str(text), scale))
    assert_streams_equal(tio.load_text_events(str(text), 1e6, max_events=7),
                         jio.load_text_events(str(text), 1e6, max_events=7))


def assert_windows_equal(a, b):
    assert (a.width, a.height, a.delta_t, a.global_min_t, a.global_max_t) == (
        b.width, b.height, b.delta_t, b.global_min_t, b.global_max_t)
    assert len(a.events) == len(b.events)
    for u, v in zip(a.events, b.events):
        assert u.dtype == v.dtype
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("fmt", ["dat", "iebcs", "h5", "csv", "v2e", "volt"])
def test_windowed_readers_match(tmp_path, fmt):
    t, x, y, p = random_stream(4, n=900, t_max=20_000)
    t = t + 1_234  # a stream that does not start at 0
    path = str(tmp_path / f"ev.{fmt}")
    if fmt in ("dat", "iebcs"):
        jio.write_dat_events(path, t, x, y, p)
    elif fmt == "h5":
        jbuf.EventBuffer.from_arrays(t, x, y, p).write_h5(path)
    elif fmt == "csv":
        jbuf.EventBuffer.from_arrays(t, x, y, p).write_csv(path)
    else:
        scale = 1e-6 if fmt == "v2e" else 1.0
        with open(path, "w") as f:
            f.writelines(f"{ti * scale!r} {xi} {yi} {pi}\n"
                         for ti, xi, yi, pi in zip(t.tolist(), x, y, p))
    assert sorted(tio.WINDOWED_READERS) == sorted(jio.WINDOWED_READERS)
    for delta_t in (1000, 3_333, 50_000):
        assert_windows_equal(tio.WINDOWED_READERS[fmt](path, delta_t),
                             jio.WINDOWED_READERS[fmt](path, delta_t))
    assert_windows_equal(tio.window_events(t, x, y, p, 2500),
                         jio.window_events(t, x, y, p, 2500))


def test_iebcs_reader_on_the_reference_edge_cases(tmp_path):
    """Remainder window, a timestamp on a window edge, one event, none."""
    cases = {
        "edges": ([100, 1100, 2100, 2101, 3100, 3550],),
        "one": ([777],),
        "none": ([],),
    }
    for name, (ts,) in cases.items():
        n = len(ts)
        path = str(tmp_path / f"{name}.dat")
        jio.write_dat_events(path, np.asarray(ts, np.uint64), np.arange(n) % 7,
                             np.arange(n) % 5, np.arange(n) % 2, width=8, height=6)
        for delta_t in (1000, 450):
            assert_windows_equal(tio.read_iebcs_windowed(path, delta_t),
                                 jio.read_iebcs_windowed(path, delta_t))


def test_metavision_reader_raises_the_same_guidance(monkeypatch):
    monkeypatch.setitem(sys.modules, "metavision_core", None)
    monkeypatch.setitem(sys.modules, "metavision_core.event_io", None)
    msgs = []
    for mod in (jio, tio):
        with pytest.raises(ImportError) as e:
            mod.read_metavision_live("x.raw", 1000)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "Metavision SDK" in msgs[0]


def test_exr_reader_raises_the_same_error_without_openexr(monkeypatch):
    monkeypatch.setitem(sys.modules, "OpenEXR", None)
    msgs = []
    for mod in (jexr, texr):
        for call in (lambda: mod.read_exr_channel("x.exr"),
                     lambda: mod.calculate_intensity_from_spectral("x.exr")):
            with pytest.raises(ImportError) as e:
                call()
            msgs.append(str(e.value))
    assert len(set(msgs)) == 1 and "OpenEXR" in msgs[0]


# ---- the DVS pixel model ---------------------------------------------------

def test_noise_histograms_are_the_jax_files():
    for level in ("low_light", "bright"):
        for a, b in zip(tdvs.default_noise_hists(level),
                        jdvs.default_noise_hists(level)):
            assert a.dtype == b.dtype and a.shape == b.shape == (256, 72)
            np.testing.assert_array_equal(a, b)
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for f in sorted(os.listdir(os.path.join(root, "event3dgs_tpu", "data", "noise"))):
        if f.endswith(".npy"):
            with open(os.path.join(root, "event3dgs_tpu", "data", "noise", f), "rb") as a, \
                    open(os.path.join(root, "event3dgs_tpu_torch", "data", "noise", f), "rb") as b:
                assert a.read() == b.read(), f


DVS_MODES = {
    "deterministic": dict(params=dict(th_noise=0.0, jitter=0.0), noise=None),
    "jitter_and_threshold_noise": dict(params={}, noise=None),
    "background_noise_bright": dict(params={}, noise="bright"),
    "background_noise_low_light": dict(params=dict(th_pos=0.2, th_neg=0.25,
                                                   refractory=300.0),
                                       noise="low_light"),
}


@pytest.mark.parametrize("mode", sorted(DVS_MODES))
def test_dvs_simulator_streams_and_voltages_are_bit_equal(mode):
    spec = DVS_MODES[mode]
    frames = luminance_frames(5)
    sims = []
    for mod in (jdvs, tdvs):
        sim = mod.DvsSimulator(W, H, params=mod.DvsParams(**spec["params"]),
                               seed=11)
        if spec["noise"]:
            sim.init_noise(*tdvs.default_noise_hists(spec["noise"]))
        else:
            sim.disable_noise()
        sim.init_image(frames[0])
        sims.append(sim)
    total = 0
    for f, dt in zip(frames[1:], (1500, 800, 20_000, 1500)):
        a, b = (s.update(f, dt) for s in sims)
        assert_streams_equal(b, a)
        total += len(a)
        for field in ("cur_v", "last_v", "time_px", "cur_ref", "tau_p",
                      "cur_th_pos", "cur_th_neg", "bgn_pos_next", "bgn_neg_next"):
            np.testing.assert_array_equal(getattr(sims[1], field),
                                          getattr(sims[0], field), err_msg=field)
    assert total > 100
    assert sims[1].params.deterministic == sims[0].params.deterministic


def test_esim_streams_are_bit_equal():
    frames = [f / 255.0 for f in luminance_frames(6)]
    sims = [mod.EsimSimulator(W, H, th_pos=0.2, th_neg=0.25) for mod in (jesim, tesim)]
    for s in sims:
        s.init_image(frames[0])
    for f in frames[1:]:
        a, b = (s.update(f, 1000.0) for s in sims)
        assert len(a) > 0
        assert_streams_equal(b, a)
        np.testing.assert_array_equal(sims[1].ref_log, sims[0].ref_log)


ARBITERS = {
    "bottleneck": lambda m: m.BottleneckArbiter(7.5, start_time=3.0),
    "row": lambda m: m.RowArbiter(40.0, H),
    "synchronous": lambda m: m.SynchronousArbiter(2.5, H, start_time=1.0),
}


@pytest.mark.parametrize("name", sorted(ARBITERS))
def test_arbiters_match(name):
    t, x, y, p = random_stream(7, n=400, t_max=5_000)
    for stream in ((t, x, y, p), tuple(a[:0] for a in (t, x, y, p))):
        outs = [ARBITERS[name](m).process(m_buf.EventBuffer.from_arrays(*stream))
                for m, m_buf in ((jarb, jbuf), (tarb, tbuf))]
        assert_streams_equal(outs[1], outs[0])


@pytest.mark.parametrize("metric", ["chamfer_distance", "gaussian_distance",
                                    "spike_cube_distance"])
def test_stream_metrics_match(metric):
    a = random_stream(8, n=600)
    b = random_stream(9, n=500)
    for pair in ((a, b), (a, a), (b, tuple(v[:0] for v in a))):
        want = getattr(jmet, metric)(*pair, W, H)
        got = getattr(tmet, metric)(*pair, W, H)
        np.testing.assert_allclose(got, want, rtol=1e-12)


# ---- accumulation and colorimetry ------------------------------------------

def accumulation_cases():
    """(x, y, p) streams: random, repeated pixels, x past the row (wraps
    into the next row, or past the image and dropped), y past the image,
    a single event and none."""
    t, x, y, p = random_stream(10, n=4000)
    rng = np.random.default_rng(10)
    rep = rng.integers(0, 6, 3000)
    wrap_x = x.astype(np.int64).copy()
    wrap_x[:400] = rng.integers(W, 3 * W, 400)
    wrap_x[400:410] = 3000
    wrap_y = y.astype(np.int64).copy()
    wrap_y[:50] = H + rng.integers(0, 3, 50)
    return {
        "random": (x, y, p),
        "repeated_pixels": (rep % 3, rep // 3, rng.integers(0, 2, 3000)),
        "x_past_the_row": (wrap_x, y, p),
        "y_past_the_image": (x, wrap_y, p),
        "one_event": ([5], [1], [1]),
        "no_event": ([], [], []),
    }


ACCUMULATORS = ["event_count_image", "accumulation_frame", "polarity_frame",
                "color_polarity_frame"]


@pytest.mark.parametrize("fn", ACCUMULATORS)
@pytest.mark.parametrize("case", ["random", "repeated_pixels", "x_past_the_row",
                                  "y_past_the_image", "one_event", "no_event"])
def test_accumulation_is_exact(fn, case):
    x, y, p = accumulation_cases()[case]
    want = np.asarray(getattr(jacc, fn)(np.asarray(x), np.asarray(y),
                                        np.asarray(p), W, H))
    got = getattr(tacc, fn)(x, y, p, W, H, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # tensors in, the same frame out
    got_t = getattr(tacc, fn)(torch.as_tensor(np.asarray(x, np.int64)),
                              torch.as_tensor(np.asarray(y, np.int64)),
                              torch.as_tensor(np.asarray(p, np.int64)), W, H,
                              device="cpu")
    np.testing.assert_array_equal(got_t.numpy(), want)


def test_accumulation_semantics_by_hand():
    """The flat index drops only outside [0, H·W): x = 5 at width 4 lands at
    (1, 1); x = 3000 is dropped; the last event of a pixel wins."""
    c = tacc.event_count_image([5, 3000, 1], [0, 0, 0], [1, 1, 0], 4, 3,
                               device="cpu")
    assert c[1, 1] == 1.0 and c[0, 1] == -1.0 and c.abs().sum() == 2.0
    pol = tacc.polarity_frame([2, 2, 2, 0], [1, 1, 1, 0], [1, 0, 1, 0], 4, 3,
                              device="cpu")
    assert pol[1, 2] == 1.0 and pol[0, 0] == 0.0 and pol[2, 3] == 0.5


def test_decode_event_frame_matches():
    x, y, p = accumulation_cases()["random"]
    img = np.asarray(jacc.color_polarity_frame(x, y, p, W, H))
    want = np.asarray(jacc.decode_event_frame(jnp.asarray(img)))
    got = tacc.decode_event_frame(img, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        np.round(got), np.asarray(jacc.event_count_image(x, y, p, W, H)))


@pytest.mark.parametrize("fn,scale", [("srgb_to_linear", 1.0),
                                      ("linear_to_srgb", 1.0),
                                      ("srgb_to_luminance", 255.0)])
def test_colorimetry_within_1e_6(fn, scale):
    """Within 1e-6 of the value's range: absolute on [0, 1], relative to
    ``max_nits`` for the luminance (float32 on both sides)."""
    rng = np.random.default_rng(12)
    img = rng.uniform(-0.2, 1.2, (2, H, W, 3)).astype(np.float32)
    img[0, 0, :4] = [[0.04045] * 3, [0.0031308] * 3, [0.0] * 3, [1.0] * 3]
    want = np.asarray(getattr(jcol, fn)(jnp.asarray(img)))
    got = getattr(tcol, fn)(torch.tensor(img))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy() / scale, want / scale, rtol=0,
                               atol=1e-6)


def test_rgb_to_luminance_and_simulate_event_camera_match(tmp_path):
    rng = np.random.default_rng(13)
    base = rng.uniform(0.05, 0.9, (H, W, 3))
    frames = [np.clip(base * (1 + 0.12 * i) + rng.normal(0, 0.01, base.shape), 0, 1)
              for i in range(5)]
    np.testing.assert_array_equal(tsim.rgb_to_luminance(frames[1]),
                                  jsim.rgb_to_luminance(frames[1]))
    for kw in ({}, dict(params=tdvs.DvsParams(th_noise=0, jitter=0), seed=3),
               dict(seed=4, noise_hist=tdvs.default_noise_hists("bright"))):
        jkw = dict(kw)
        if "params" in kw:
            jkw["params"] = jdvs.DvsParams(th_noise=0, jitter=0)
        a = jsim.simulate_event_camera(frames, dt=700, **jkw)
        b = tsim.simulate_event_camera(frames, dt=700, **kw)
        assert len(a) > 0
        assert_streams_equal(b, a)
    assert len(tsim.simulate_event_camera([])) == 0
    paths = [m.save_event_result(b, str(tmp_path / name), width=W, height=H)
             for m, name in ((jsim, "j"), (tsim, "t"))]
    with open(paths[0], "rb") as f0, open(paths[1], "rb") as f1:
        assert f0.read() == f1.read()


# ---- generate_event_frames -------------------------------------------------

def layout_stream():
    """Events spread over 6 ms from t = 250 µs, with repeated pixels and
    events in the trailing 90 % of each window."""
    rng = np.random.default_rng(14)
    n = 3000
    t = np.sort(rng.integers(250, 6_000, n)).astype(np.uint64)
    return (t, rng.integers(0, W, n).astype(np.uint16),
            rng.integers(0, H, n).astype(np.uint16),
            rng.integers(0, 2, n).astype(np.uint8))


def pngs(root):
    """{relative path: pixels} of every PNG under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".png"):
                path = os.path.join(d, f)
                out[os.path.relpath(path, root)] = np.asarray(Image.open(path))
    return out


def assert_same_pngs(a, b):
    pa, pb = pngs(a), pngs(b)
    assert sorted(pa) == sorted(pb) and pa
    for k in pa:
        np.testing.assert_array_equal(pb[k], pa[k], err_msg=k)


@pytest.mark.parametrize("layout", [None, "default", "volt", "edslike", "eds",
                                    "T", "tumvie"])
def test_generate_event_frames_layouts_match(tmp_path, layout):
    """Each of the six reference layouts (and the generic windows): the same
    file names, the same directories and pixels exactly, in both styles,
    with and without ``total_frames``."""
    stream = layout_stream()
    for style in ("accumulate", "color"):
        for total in (None, 4, 9):
            outs = []
            for name, mbuf, msim, kw in (("jax", jbuf, jsim, {}),
                                         ("torch", tbuf, tsim, {"device": "cpu"})):
                root = tmp_path / f"{style}_{total}_{name}"
                frames = msim.generate_event_frames(
                    mbuf.EventBuffer.from_arrays(*stream), W, H, 1000,
                    out_dir=str(root / "out"), style=style, layout=layout,
                    total_frames=total, **kw)
                outs.append((root, frames))
            (ja, jf), (ta, tf) = outs
            assert len(tf) == len(jf) > 0
            for a, b in zip(jf, tf):
                assert isinstance(b, np.ndarray) and b.dtype == a.dtype
                np.testing.assert_array_equal(b, a)
            assert_same_pngs(ja, ta)


# ---- display ---------------------------------------------------------------

def structured_window(seed):
    t, x, y, p = random_stream(seed, n=800, t_max=100_000)
    w = np.zeros(len(t), jio.WINDOW_DTYPE)
    w["x"], w["y"], w["p"], w["t"] = x, y, p, t
    return w


@pytest.mark.parametrize("mode", ["binary", "time_surface"])
def test_event_display_matches(tmp_path, mode):
    t, x, y, p = random_stream(15, n=3000, t_max=200_000)
    frames = []
    for name, mod in (("jax", jdisp), ("torch", tdisp)):
        disp = mod.EventDisplay(W, H, frametime=33_000.0, mode=mode,
                                out_dir=str(tmp_path / name))
        for lo in range(0, 3000, 700):
            disp.update(t[lo:lo + 700], x[lo:lo + 700], y[lo:lo + 700], p[lo:lo + 700])
        frames.append(disp.frames)
    assert len(frames[0]) == len(frames[1]) > 3
    for a, b in zip(*frames):
        np.testing.assert_array_equal(b, a)
    assert_same_pngs(tmp_path / "jax", tmp_path / "torch")


def test_display_frame_and_cloud_match():
    w = structured_window(16)
    for lo, hi in ((0, 100_000), (20_000, 30_000)):
        np.testing.assert_array_equal(
            tdisp.display_events_frame(w, lo, hi, W, H),
            jdisp.display_events_frame(w, lo, hi, W, H))
        a, b = jdisp.event_cloud_3d(w, lo, hi), tdisp.event_cloud_3d(w, lo, hi)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(v, u)
