"""``cli.generate_dataset`` and the five example scripts of the port
against the JAX package's, on the CPU: the same files, pixels exactly, the
same ``.dat`` bytes and the same printed lines."""

import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from event3dgs_tpu.cli.generate_dataset import main as jgen
from event3dgs_tpu.events import buffer as jbuf
from event3dgs_tpu.examples import compare_streams as jcmp
from event3dgs_tpu.examples import exr_to_events as jexr
from event3dgs_tpu.examples import images_to_events as ji2e
from event3dgs_tpu.examples import noise_calibration as jnc
from event3dgs_tpu.examples import video_to_events as jv2e
from event3dgs_tpu_torch.cli.generate_dataset import main as tgen
from event3dgs_tpu_torch.examples import compare_streams as tcmp
from event3dgs_tpu_torch.examples import exr_to_events as texr
from event3dgs_tpu_torch.examples import images_to_events as ti2e
from event3dgs_tpu_torch.examples import noise_calibration as tnc
from event3dgs_tpu_torch.examples import video_to_events as tv2e
from test_torch_events import assert_same_pngs, random_stream

torch.set_num_threads(1)

W, H = 64, 48


def run_both(capsys, jmain, tmain, args_for, device=True):
    """Run the JAX and the port entry point with ``args_for(name)``; both
    must exit 0 and print the same lines (paths aside)."""
    printed = []
    for name, main in (("jax", jmain), ("torch", tmain)):
        extra = ["--device", "cpu"] if name == "torch" and device else []
        assert main(args_for(name) + extra) == 0
        printed.append(capsys.readouterr().out.replace(f"/{name}", "/X"))
    assert printed[0] == printed[1]
    return printed[1]


def write_stream(path, fmt, seed):
    t, x, y, p = random_stream(seed, n=1500, t_max=9_000)
    t = t + 700
    buf = jbuf.EventBuffer.from_arrays(t, x, y, p)
    if fmt in ("dat", "iebcs"):
        buf.write_dat(path, width=W, height=H)
    elif fmt == "csv":
        buf.write_csv(path)
    elif fmt == "h5":
        buf.write_h5(path)
    else:  # volt: whitespace-separated µs
        with open(path, "w") as f:
            f.writelines(f"{a} {b} {c} {d}\n" for a, b, c, d in zip(t, x, y, p))


STREAM_CASES = {
    "dat_generic": ("dat", [], "accumulate"),
    "dat_default_layout_color": ("dat", ["--layout", "default"], "color"),
    "csv_eds_layout": ("csv", ["--layout", "eds", "--total_frames", "12"], "accumulate"),
    "iebcs_T_layout": ("iebcs", ["--layout", "T"], "accumulate"),
    "volt_generic_color": ("volt", ["--total_frames", "3"], "color"),
    "h5_tumvie_layout": ("h5", ["--layout", "tumvie", "--width", "70",
                                "--height", "50"], "accumulate"),
    "dat_volt_layout": ("dat", ["--layout", "volt", "--delta_t", "2500"], "accumulate"),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_events_mode_matches_jax(tmp_path, capsys, case):
    fmt, extra, style = STREAM_CASES[case]
    src = str(tmp_path / f"stream.{fmt}")
    write_stream(src, fmt, seed=len(case))
    out = run_both(capsys, jgen, tgen, lambda name: [
        "--events", src, "--format", fmt, "--delta_t", "1000", "--style", style,
        "-o", str(tmp_path / name / "images_event"), *extra])
    assert "event frames" in out
    assert_same_pngs(tmp_path / "jax", tmp_path / "torch")


def write_images(folder, seed, n=5, width=W, height=H):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.1, 0.8, (height, width, 3))
    for i in range(n):
        img = np.clip(base * (1 + 0.1 * i) + rng.normal(0, 0.02, base.shape), 0, 1)
        Image.fromarray((img * 255).astype(np.uint8)).save(
            os.path.join(folder, f"img_{i:03d}.png"))


def assert_same_files(a, b, names):
    for f in names:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


@pytest.mark.parametrize("style", ["accumulate", "color"])
def test_images_mode_matches_jax(tmp_path, capsys, style):
    write_images(tmp_path / "imgs", seed=1)
    out = run_both(capsys, jgen, tgen, lambda name: [
        "--images", str(tmp_path / "imgs"), "--dt", "800", "--delta_t", "1500",
        "--style", style, "-o", str(tmp_path / name)])
    assert "wrote" in out and "events to" in out
    assert_same_files(tmp_path / "jax", tmp_path / "torch", ["raw.dat"])
    assert_same_pngs(tmp_path / "jax", tmp_path / "torch")


def test_images_to_events_matches_jax(tmp_path, capsys):
    write_images(tmp_path / "imgs", seed=2, n=6)
    hist = tmp_path / "hist.npy"
    np.save(hist, jnc.synthesize_histogram(50.0, n_pixels=8))
    for extra in ([], ["--th_noise", "0", "--jitter", "0", "--max_images", "4"],
                  ["--noise_hist", str(hist), "--threshold", "0.2"]):
        run_both(capsys, ji2e.main, ti2e.main, lambda name: [
            "--images", str(tmp_path / "imgs"), "-o", str(tmp_path / name),
            "--dt", "300", "--delta_t", "600", *extra])
        assert_same_files(tmp_path / "jax", tmp_path / "torch", ["raw.dat"])
        assert_same_pngs(tmp_path / "jax", tmp_path / "torch")


def test_noise_calibration_matches_jax(tmp_path, capsys):
    for name in ("jax", "torch"):
        (tmp_path / name).mkdir()
    for args in (["--synthesize", "0.5", "-o", "a.npy"],
                 ["--synthesize", "2000", "-o", "b.npy"],
                 ["--inputs", "a.npy", "b.npy", "-o", "avg.npy"]):
        run_both(capsys, jnc.main, tnc.main, lambda name: [
            str(tmp_path / name / a) if a.endswith(".npy") else a for a in args],
            device=False)
    for f in ("a.npy", "b.npy", "avg.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "torch" / f),
                                      np.load(tmp_path / "jax" / f))
    np.testing.assert_array_equal(tnc.CANDIDATE_RATES, jnc.CANDIDATE_RATES)
    for mod in (jnc, tnc):
        with pytest.raises(SystemExit):
            mod.main(["-o", str(tmp_path / "x.npy")])


def test_compare_streams_matches_jax(tmp_path, capsys):
    """The report to the last digit, the count frames' pixels (written
    with PIL by the port, with OpenCV by the JAX package) and the clouds.
    Where OpenCV is missing the JAX script stops at its import and the port
    still writes its report."""
    real, sim = str(tmp_path / "real.dat"), str(tmp_path / "sim.dat")
    for path, seed in ((real, 3), (sim, 4)):
        t, x, y, p = random_stream(seed, n=900, t_max=120_000)
        jbuf.EventBuffer.from_arrays(t, x, y, p).write_dat(path, width=W, height=H)
    args = lambda name: ["--real", real, "--sim", sim, "--sim_format", "dat",
                         "-o", str(tmp_path / name), "--delta_t", "100000",
                         "--max_events", "500"]
    try:
        import cv2  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            jcmp.main(args("jax"))
        assert tcmp.main(args("torch")) == 0
        assert (tmp_path / "torch" / "comparison.json").exists()
        return
    run_both(capsys, jcmp.main, tcmp.main, args, device=False)
    reports = [json.loads((tmp_path / n / "comparison.json").read_text())
               for n in ("jax", "torch")]
    assert reports[0] == reports[1]
    assert reports[1]["chamfer"] > 0 and len(reports[1]["bias_sweep"]) == 6
    assert_same_pngs(tmp_path / "jax", tmp_path / "torch")
    for name in ("cloud_real.npz", "cloud_sim.npz"):
        a, b = (np.load(tmp_path / n / name) for n in ("jax", "torch"))
        for k in ("positions", "colors"):
            np.testing.assert_array_equal(b[k], a[k])


def test_exr_to_events_raises_the_jax_error_without_openexr(tmp_path, monkeypatch):
    """Without the OpenEXR bindings both scripts stop with the same
    ImportError at the first EXR."""
    monkeypatch.setitem(sys.modules, "OpenEXR", None)
    (tmp_path / "exr").mkdir()
    (tmp_path / "exr" / "f_000.exr").write_bytes(b"")
    msgs = []
    for main, extra in ((jexr.main, []), (texr.main, ["--device", "cpu"])):
        with pytest.raises(ImportError) as e:
            main(["--exr_dir", str(tmp_path / "exr"), "-o", str(tmp_path / "o"),
                  *extra])
        msgs.append(str(e.value))
        with pytest.raises(SystemExit, match="no .exr files"):
            main(["--exr_dir", str(tmp_path), "-o", str(tmp_path / "o"), *extra])
    assert msgs[0] == msgs[1] and "OpenEXR" in msgs[0]


def test_video_to_events_matches_jax(tmp_path, capsys):
    """On a short MJPG video: the same ``.dat`` bytes and display frames;
    where OpenCV is missing, the same import error from both."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is None:
        for main in (jv2e.main, tv2e.main):
            with pytest.raises(ImportError, match="cv2"):
                main(["--video", "x.avi", "-o", str(tmp_path / "o")])
        return
    video = str(tmp_path / "in.avi")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 30, (W, H))
    rng = np.random.default_rng(5)
    base = rng.uniform(30, 200, (H, W, 3))
    for i in range(8):
        writer.write(np.clip(base * (1 + 0.08 * i), 0, 255).astype(np.uint8))
    writer.release()
    run_both(capsys, jv2e.main, tv2e.main, lambda name: [
        "--video", video, "-o", str(tmp_path / name), "--dt", "2000"], device=False)
    dats = sorted(f for f in os.listdir(tmp_path / "torch") if f.endswith(".dat"))
    assert dats == sorted(f for f in os.listdir(tmp_path / "jax") if f.endswith(".dat"))
    assert len(dats) == 1
    assert_same_files(tmp_path / "jax", tmp_path / "torch", dats)
    assert_same_pngs(tmp_path / "jax", tmp_path / "torch")
