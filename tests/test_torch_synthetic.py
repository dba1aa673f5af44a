"""The port's data preparation against the JAX package's, on the CPU.

- ``data.synthetic``: ``orbit_cameras`` and ``make_synthetic_scene`` — the
  same points (the numpy RNG stream is shared), cameras within float32
  rounding, GT images
  within the render tolerance of tests/test_rasterize_tiled.py (atol 2e-5,
  rtol 1e-4);
- ``tools.make_scene.synthesize_scene``: the same files, PNGs within one
  8-bit level, the COLMAP model and the point cloud PLY equal and readable
  by both packages (blurry captures included);
- ``tools.dataset_prep``: the same outputs from the same images, and the
  same errors where OpenCV cannot be imported;
- ``cli.convert``: the same ``colmap`` command lines (a fake ``colmap`` on
  ``PATH`` logs its arguments) and the exit when ``colmap`` is missing.
"""

import os
import shutil
import stat
import sys

import numpy as np
import pytest
from PIL import Image

from event3dgs_tpu.cli import convert as jconvert
from event3dgs_tpu.data import colmap as jcolmap
from event3dgs_tpu.data import ply as jply
from event3dgs_tpu.data.synthetic import make_synthetic_scene as jscene
from event3dgs_tpu.data.synthetic import orbit_cameras as jorbit
from event3dgs_tpu.tools import dataset_prep as jprep
from event3dgs_tpu.tools.make_scene import synthesize_scene as jsynth
from event3dgs_tpu_torch.cli import convert as tconvert
from event3dgs_tpu_torch.data import colmap as tcolmap
from event3dgs_tpu_torch.data import ply as tply
from event3dgs_tpu_torch.data.synthetic import make_synthetic_scene as tscene
from event3dgs_tpu_torch.data.synthetic import orbit_cameras as torbit
from event3dgs_tpu_torch.tools import dataset_prep as tprep
from event3dgs_tpu_torch.tools import make_scene as tmake
from event3dgs_tpu_torch.tools.make_scene import synthesize_scene as tsynth

CAM_FIELDS = ("world_view", "full_proj", "camera_center", "tan_fovx",
              "tan_fovy")


def cameras_close(t, j):
    """Camera fields within float32 rounding: the JAX package builds them in
    float32, the port in float64 (tests/test_torch_core.py's rule)."""
    for f in CAM_FIELDS:
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)


def test_orbit_cameras_match_jax():
    for kw in (dict(), dict(n_views=5, radius=3.0, height=0.2, width=40,
                            img_height=30, arc=0.7)):
        kw = {"n_views": 6, **kw}
        for j, t in zip(jorbit(**kw), torbit(**kw, device="cpu")):
            assert (t.width, t.height) == (j.width, j.height)
            cameras_close(t, j)


def test_make_synthetic_scene_matches_jax():
    j = jscene(n_gaussians=60, n_views=6, width=64, height=48, seed=3)
    t = tscene(n_gaussians=60, n_views=6, width=64, height=48, seed=3,
               device="cpu")
    np.testing.assert_array_equal(t.points, j.points)
    np.testing.assert_array_equal(t.colors, j.colors)
    assert t.extent == j.extent
    for k, v in j.true_model.items():
        np.testing.assert_array_equal(t.true_model[k], v, k)
    cameras_close(t.cameras, j.cameras)
    assert t.images.shape == (6, 48, 64, 3)
    assert float(t.images.max()) > 0.1
    np.testing.assert_allclose(t.images.numpy(), np.asarray(j.images),
                               atol=2e-5, rtol=1e-4)
    # the scene through the ported kernels' plain versions too
    tiled = tscene(n_gaussians=60, n_views=6, width=64, height=48, seed=3,
                   device="cpu", rasterizer="tiled")
    np.testing.assert_allclose(tiled.images.numpy(), np.asarray(j.images),
                               atol=2e-5, rtol=1e-4)


def files_under(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    kw = dict(n_views=6, width=40, height=32, n_gaussians=50, seed=2,
              white_background=True, blur_steps=2, init_fraction=0.8)
    meta_j = jsynth(str(root / "jax"), **kw)
    meta_t = tsynth(str(root / "torch"), **kw, device="cpu")
    return root / "jax", root / "torch", meta_j, meta_t


def test_synthesize_scene_matches_jax(scenes):
    jdir, tdir, meta_j, meta_t = scenes
    names = files_under(jdir)
    assert names == files_under(tdir)
    assert len([n for n in names if n.endswith(".png")]) == 6 * 4
    for k in ("n_views", "width", "height", "n_gaussians"):
        assert meta_t[k] == meta_j[k]
    for k, v in meta_j["true_model"].items():
        np.testing.assert_array_equal(meta_t["true_model"][k], v, k)
    for name in names:
        if name.endswith(".png"):
            a = np.asarray(Image.open(tdir / name), np.int16)
            b = np.asarray(Image.open(jdir / name), np.int16)
            assert np.abs(a - b).max() <= 1, name
            assert a.max() > 0, name


def test_synthesized_model_reads_in_both_packages(scenes):
    jdir, tdir, _, _ = scenes
    sparse_j, sparse_t = str(jdir / "sparse" / "0"), str(tdir / "sparse" / "0")
    for read in (jcolmap.read_model, tcolmap.read_model):
        cams_j, imgs_j, pts_j = read(sparse_j)
        cams_t, imgs_t, pts_t = read(sparse_t)
        assert cams_t.keys() == cams_j.keys() and imgs_t.keys() == imgs_j.keys()
        for i in imgs_j:
            np.testing.assert_array_equal(imgs_t[i].qvec, imgs_j[i].qvec)
            np.testing.assert_array_equal(imgs_t[i].tvec, imgs_j[i].tvec)
            assert imgs_t[i].name == imgs_j[i].name
        np.testing.assert_array_equal(cams_t[1].params, cams_j[1].params)
        for a, b in zip(pts_t, pts_j):
            np.testing.assert_array_equal(a, b)
        assert pts_t[0].shape == (40, 3)  # init_fraction 0.8 of 50
    for fetch in (jply.fetch_point_cloud, tply.fetch_point_cloud):
        pj = fetch(os.path.join(sparse_j, "points3D.ply"))
        pt = fetch(os.path.join(sparse_t, "points3D.ply"))
        np.testing.assert_array_equal(pt.points, pj.points)
        np.testing.assert_array_equal(pt.colors, pj.colors)


def test_make_scene_cli(tmp_path, capsys):
    out = tmp_path / "cli"
    assert tmake.main(["-o", str(out), "--views", "3", "--width", "16",
                       "--height", "16", "--gaussians", "10",
                       "--device", "cpu"]) == 0
    assert "wrote 3-view scene" in capsys.readouterr().out
    assert len(os.listdir(out / "images")) == 3


def test_dataset_prep_matches_jax(scenes, tmp_path, monkeypatch):
    _, tdir, _, _ = scenes
    src = str(tdir / "images")
    for name, fn_j, fn_t, kw in (
            ("blurry", jprep.generate_blurry_images,
             tprep.generate_blurry_images, dict(window=3, box=5)),
            ("recolor", jprep.recolor_background, tprep.recolor_background,
             dict(threshold=0.05, new_color=(0.2, 0.3, 0.4), dark=False)),
            ("tumvie", jprep.rename_for_tumvie, tprep.rename_for_tumvie, {}),
            ("e2vid", jprep.rename_for_e2vid, tprep.rename_for_e2vid,
             dict(dt_us=500, start_us=7))):
        rj = fn_j(src, str(tmp_path / f"{name}_j"), **kw)
        rt = fn_t(src, str(tmp_path / f"{name}_t"), **kw)
        if name == "e2vid":
            rj, rt = os.path.basename(rj), os.path.basename(rt)
        assert rt == rj, name
        files = files_under(tmp_path / f"{name}_j")
        assert files == files_under(tmp_path / f"{name}_t") and files
        for f in files:
            a = (tmp_path / f"{name}_t" / f).read_bytes()
            assert a == (tmp_path / f"{name}_j" / f).read_bytes(), (name, f)
    # the box filter alone, on a ragged array
    img = np.random.default_rng(0).uniform(size=(9, 7, 3))
    np.testing.assert_array_equal(tprep._box_filter(img, 3),
                                  jprep._box_filter(img, 3))
    # the card's machine has no OpenCV: both packages raise the same error
    monkeypatch.setitem(sys.modules, "cv2", None)
    for fn in ("images_to_video", "video_to_images"):
        with pytest.raises(ImportError) as ej:
            getattr(jprep, fn)(src, str(tmp_path / "v"))
        with pytest.raises(ImportError) as et:
            getattr(tprep, fn)(src, str(tmp_path / "v"))
        assert str(et.value) == str(ej.value)


def fake_colmap(bin_dir, log):
    """A ``colmap`` that logs its arguments and, for the undistorter,
    writes the sparse files convert moves into sparse/0."""
    bin_dir.mkdir(exist_ok=True)
    exe = bin_dir / "colmap"
    exe.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> "{log}"\n'
        'if [ "$1" = image_undistorter ]; then\n'
        '  out=""; prev=""\n'
        '  for a in "$@"; do [ "$prev" = --output_path ] && out="$a"; '
        'prev="$a"; done\n'
        '  mkdir -p "$out/sparse" "$out/images"\n'
        '  touch "$out/sparse/cameras.bin" "$out/sparse/images.bin"\n'
        'fi\n')
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)


def test_convert_matches_jax(tmp_path, monkeypatch, capsys):
    logs = {}
    for name, main in (("jax", jconvert.main), ("torch", tconvert.main)):
        src = tmp_path / name / "scene"
        (src / "input").mkdir(parents=True)
        log = tmp_path / f"{name}.log"
        fake_colmap(tmp_path / "bin", log)
        monkeypatch.setenv("PATH", f"{tmp_path / 'bin'}{os.pathsep}"
                           f"{os.environ['PATH']}")
        assert main(["-s", str(src), "--no_gpu"]) == 0
        assert sorted(os.listdir(src / "sparse" / "0")) == ["cameras.bin",
                                                             "images.bin"]
        logs[name] = log.read_text().replace(str(src), "<src>")
    assert logs["torch"] == logs["jax"]
    assert logs["jax"].count("\n") == 4 and "SiftExtraction.use_gpu 0" in logs["jax"]
    capsys.readouterr()

    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    errs = {}
    for name, main in (("jax", jconvert.main), ("torch", tconvert.main)):
        assert main(["-s", str(tmp_path / name / "scene")]) == 1
        errs[name] = capsys.readouterr().err
    assert errs["torch"] == errs["jax"] and "'colmap' not found" in errs["jax"]
    assert shutil.which("colmap") is None
