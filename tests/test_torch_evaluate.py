"""The port's evaluation slice against the JAX package's, on the CPU: LPIPS
(all three backbones, one ``.npz`` of random weights read by both
packages), ``evaluate_holdout``, ``metrics_over_dirs`` and the
``evaluate``, ``metrics`` and ``full_eval`` entry points on a tiny COLMAP
scene written by the JAX ``tools/make_scene.synthesize_scene``.

Tolerances: LPIPS feature maps per stage at rtol 1e-4 / atol 1e-6 after
dividing by the stage's largest magnitude (float32 convolutions in two
libraries sum in different orders, so their absolute error grows with the
stage's scale) and the distance at rtol 1e-4 / atol 1e-6; SSIM within
1e-5, PSNR within 1e-3 dB; PNGs within 1 LSB.
"""

import json
import os
import re
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from event3dgs_tpu.cli import evaluate as jevaluate
from event3dgs_tpu.cli import full_eval as jfull_eval
from event3dgs_tpu.cli import metrics as jmetrics
from event3dgs_tpu.cli.render import main as jrender_main
from event3dgs_tpu.core.sh import rgb_to_sh
from event3dgs_tpu.data import ply as jply
from event3dgs_tpu.data import scene as jscene
from event3dgs_tpu.losses import lpips as jlpips
from event3dgs_tpu.models import gaussians as jgauss
from event3dgs_tpu.tools import evaluation as jeval
from event3dgs_tpu.tools.make_scene import synthesize_scene
from event3dgs_tpu.utils.config import TrainConfig
from event3dgs_tpu_torch.cli import evaluate as tevaluate
from event3dgs_tpu_torch.cli import full_eval as tfull_eval
from event3dgs_tpu_torch.cli import metrics as tmetrics
from event3dgs_tpu_torch.cli.render import main as trender_main
from event3dgs_tpu_torch.data import ply as tply
from event3dgs_tpu_torch.data import scene as tscene
from event3dgs_tpu_torch.losses import lpips as tlpips
from event3dgs_tpu_torch.tools import evaluation as teval

torch.set_num_threads(1)

NETS = ("alex", "vgg", "squeeze")
W, H, VIEWS, ITER = 48, 40, 8, 3
LINE = re.compile(r"\[SSIM (\S+) PSNR ([^\s\]]+)(?: LPiPS ([^\s\]]+))?\]")


def lpips_arrays(net, seed=0):
    """Random weights in the ``.npz`` layout: He-normal kernels, small
    biases, non-negative heads."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, shape in tlpips.weight_shapes(net).items():
        if len(shape) == 4:
            fan_in = shape[0] * shape[1] * shape[2]
            out[key] = rng.normal(0, np.sqrt(2.0 / fan_in), shape)
        elif key.startswith("lin"):
            out[key] = np.abs(rng.normal(0, 1, shape))
        else:
            out[key] = rng.normal(0, 0.05, shape)
    return {k: v.astype(np.float32) for k, v in out.items()}


@pytest.fixture(scope="module")
def lpips_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("lpips")
    paths = {}
    for net in NETS:
        paths[net] = str(root / f"lpips_{net}.npz")
        np.savez(paths[net], **lpips_arrays(net))
    return paths


def image_pair(h, w, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("size", [(64, 64), (67, 83)])
@pytest.mark.parametrize("net", NETS)
def test_lpips_features_and_distance_match(lpips_files, net, size):
    jp = jlpips.load_weights(lpips_files[net])
    tp = tlpips.load_weights(lpips_files[net])
    a, b = image_pair(*size)
    x = (a - np.float32(jlpips._SHIFT)) / np.float32(jlpips._SCALE)
    jfeats = jlpips._BACKBONES[net][0](jp, jnp.asarray(x)[None])
    tfeats = tlpips._BACKBONES[net][0](tp, torch.tensor(x).permute(2, 0, 1)[None])
    assert len(tfeats) == len(jfeats) == tlpips._BACKBONES[net][1]
    for i, (j, t) in enumerate(zip(jfeats, tfeats)):
        j, t = np.asarray(j), t.permute(0, 2, 3, 1).numpy()
        assert t.shape == j.shape, (i, t.shape, j.shape)
        scale = np.abs(j).max()
        assert scale > 0
        np.testing.assert_allclose(t / scale, j / scale, rtol=1e-4, atol=1e-6,
                                   err_msg=f"{net} stage {i}")
    want = float(jlpips.lpips_distance(jp, jnp.asarray(a), jnp.asarray(b), net))
    got = tlpips.lpips_distance(tp, torch.tensor(a), torch.tensor(b), net)
    np.testing.assert_allclose(float(got), want, rtol=1e-4, atol=1e-6)
    module = tlpips.lpips_fn(lpips_files[net], net=net, device="cpu")
    assert isinstance(module, tlpips.LPIPS)
    assert sorted(module.state_dict()) == sorted(tlpips.weight_shapes(net))
    assert float(module(torch.tensor(a), torch.tensor(b))) == float(got)
    jfn = jlpips.lpips_fn(lpips_files[net], net=net)
    np.testing.assert_allclose(float(got), float(jfn(a, b)), rtol=1e-4, atol=1e-6)
    assert float(module(torch.tensor(a), torch.tensor(a))) == pytest.approx(
        0.0, abs=1e-6)


@pytest.mark.parametrize("hw", [(7, 7), (8, 8), (9, 12), (12, 9), (14, 15)])
def test_ceil_maxpool_matches(hw):
    """SqueezeNet's ceil-mode pool, at odd and even sizes: the -inf pad
    and the pool without padding, equal to the JAX package's."""
    x = np.random.default_rng(hw[0] * 31 + hw[1]).normal(
        size=(1, *hw, 5)).astype(np.float32)
    want = np.asarray(jlpips._ceil_maxpool(jnp.asarray(x)))
    got = tlpips._ceil_maxpool(torch.tensor(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    assert want.shape[1:3] == tuple(-(-(n - 3) // 2) + 1 for n in hw)


# torchvision feature indices of each backbone's convolutions, the LPIPS
# head key form each case uses (all three forms are accepted)
TORCH_LAYOUT = {
    "alex": ([0, 3, 6, 8, 10], "lin{}.model.1.weight"),
    "vgg": ([0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28],
            "lins.{}.model.1.weight"),
    "squeeze": ([3, 4, 6, 7, 9, 10, 11, 12], "lin.{}.model.1.weight"),
}


@pytest.mark.parametrize("net", NETS)
def test_convert_torch_weights_writes_the_jax_file(net, tmp_path):
    """One fake torch state dict through both converters: the same keys
    and arrays (the port's converter takes tensors, the JAX one arrays)."""
    arrays = lpips_arrays(net, seed=3)
    layers, head_key = TORCH_LAYOUT[net]
    state = {"classifier.weight": np.zeros((2, 2), np.float32)}  # ignored

    def put(src, name):
        state[f"{src}.weight"] = arrays[f"{name}_w"].transpose(3, 2, 0, 1)
        state[f"{src}.bias"] = arrays[f"{name}_b"]

    if net == "squeeze":
        put("0", "conv0")
        for i, fi in enumerate(layers):
            for part, suffix in (("squeeze", "s"), ("expand1x1", "e1"),
                                 ("expand3x3", "e3")):
                put(f"{fi}.{part}", f"fire{i + 1}_{suffix}")
    else:
        for i, ci in enumerate(layers):
            put(str(ci), f"conv{i}")
    heads = {head_key.format(i): arrays[f"lin{i}_w"][None, :, None, None]
             for i in range(tlpips._BACKBONES[net][1])}
    jlpips.convert_torch_weights(state, heads, str(tmp_path / "j.npz"), net)
    tlpips.convert_torch_weights(
        {k: torch.tensor(v) for k, v in state.items()},
        {k: torch.tensor(v) for k, v in heads.items()},
        str(tmp_path / "t.npz"), net)
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert sorted(t.files) == sorted(j.files) == sorted(arrays)
        for k in j.files:
            assert t[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
            np.testing.assert_array_equal(t[k], arrays[k], err_msg=k)
    with pytest.raises(ValueError, match="backbone"):
        tlpips.convert_torch_weights(state, heads, str(tmp_path / "x.npz"),
                                     "resnet")


def test_lpips_fn_without_weights_warns(monkeypatch, tmp_path):
    monkeypatch.delenv("EVENT3DGS_LPIPS_WEIGHTS", raising=False)
    for path in (None, str(tmp_path / "missing.npz")):
        with pytest.warns(UserWarning, match="event3dgs_tpu_torch.losses.lpips"
                                             ".convert_torch_weights"):
            assert tlpips.lpips_fn(path) is None


# --------------------------------------------------------------------------
# the evaluation protocol on a tiny COLMAP scene


def write_model(path, src, params):
    cfg = TrainConfig()
    cfg.model.source_path = str(src)
    cfg.model.resolution = 1
    cfg.model.white_background = True
    cfg.model.gray = True
    (path / "point_cloud" / f"iteration_{ITER}").mkdir(parents=True)
    (path / "cfg.json").write_text(cfg.to_json())
    jply.save_gaussian_ply(
        str(path / "point_cloud" / f"iteration_{ITER}" / "point_cloud.ply"),
        params)


@pytest.fixture(scope="module")
def colmap_scene(tmp_path_factory):
    """A scene with ``renders/`` (8 views), the scene's own Gaussians moved
    a little as the model (so PSNR is finite), one model dir per package."""
    root = tmp_path_factory.mktemp("evalscene")
    src = root / "scene"
    truth = synthesize_scene(str(src), n_views=VIEWS, width=W, height=H,
                             n_gaussians=60, white_background=True)["true_model"]
    rng = np.random.default_rng(1)
    n = truth["means"].shape[0]
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    params = jgauss.init_from_point_cloud(truth["means"], truth["colors"], n)
    opac = np.clip(np.asarray(truth["opacities"]).reshape(n, 1), 0.02, 0.98)
    params = params.replace(
        xyz=f32(truth["means"] + rng.normal(0, 0.03, (n, 3))),
        features_dc=f32(rgb_to_sh(np.asarray(truth["colors"]))[:, None, :]),
        scaling=f32(np.log(np.asarray(truth["scales"]).reshape(n, 3))),
        rotation=f32(np.asarray(truth["quats"]).reshape(n, 4)),
        opacity=f32(np.log(opac / (1 - opac))),
    )
    models = {}
    for pkg in ("jax", "torch"):
        models[pkg] = root / f"model_{pkg}"
        write_model(models[pkg], src, params)
    return src, models, params


def holdout_inputs(src):
    jinfo = jscene.read_colmap_scene(str(src), gray=True)
    tinfo = tscene.read_colmap_scene(str(src), gray=True)
    assert len(tinfo.test_cameras) == VIEWS
    gt = tscene.load_images_array(tinfo.test_cameras, 1, True)
    np.testing.assert_array_equal(
        gt, jscene.load_images_array(jinfo.test_cameras, 1, True))
    return (jscene.build_camera_batch(jinfo.test_cameras, 1),
            tscene.build_camera_batch(tinfo.test_cameras, 1, device="cpu"), gt)


def assert_pngs_close(dir_a, dir_b, names):
    assert sorted(os.listdir(dir_a)) == sorted(os.listdir(dir_b)) == sorted(names)
    for name in names:
        a = np.asarray(Image.open(os.path.join(dir_a, name)), np.int16)
        b = np.asarray(Image.open(os.path.join(dir_b, name)), np.int16)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1, (name, np.abs(a - b).max())


SCORE_TOL = {"SSIM": dict(rtol=0, atol=1e-5), "PSNR": dict(rtol=0, atol=1e-3),
             "LPIPS": dict(rtol=1e-4, atol=1e-6)}


def assert_scores_close(got, want):
    """The metrics of ``want`` (any of SSIM, PSNR, LPIPS) in ``got``."""
    assert sorted(got) == sorted(want)
    for key, tol in SCORE_TOL.items():
        if key in want:
            np.testing.assert_allclose(got[key], want[key], err_msg=key, **tol)


@pytest.mark.parametrize("rasterizer", ["tiled", "reference"])
def test_evaluate_holdout_matches_jax(colmap_scene, lpips_files, tmp_path,
                                      rasterizer):
    src, _, params = colmap_scene
    jcams, tcams, gt = holdout_inputs(src)
    kw = dict(sh_degree=3, indices=(1, 5, 6, 25),
              lpips_weights=lpips_files["alex"], rasterizer=rasterizer)
    want = jeval.evaluate_holdout(params, jcams, jnp.asarray(gt),
                                  background=jnp.ones(3),
                                  save_dir=str(tmp_path / "j"), **kw)
    got = teval.evaluate_holdout(tply.load_gaussian_ply(
        str(colmap_scene[1]["torch"] / "point_cloud" / f"iteration_{ITER}"
            / "point_cloud.ply"), device="cpu"),
        tcams, gt, background=torch.ones(3), save_dir=str(tmp_path / "t"), **kw)
    assert got["indices"] == want["indices"] == [1, 5, 6]
    assert_scores_close(got, want)
    assert "LPIPS" in got and 10 < got["PSNR"] < 60  # finite, not trivial
    np.testing.assert_allclose(got["per_view_ssim"], want["per_view_ssim"],
                               atol=1e-5)
    np.testing.assert_allclose(got["per_view_psnr"], want["per_view_psnr"],
                               atol=1e-3)
    assert_pngs_close(tmp_path / "j", tmp_path / "t",
                      [f"{p}_{i:05d}.png" for i in (1, 5, 6)
                       for p in ("sim", "real")])


def test_evaluate_holdout_without_weights_omits_lpips(colmap_scene, monkeypatch):
    monkeypatch.delenv("EVENT3DGS_LPIPS_WEIGHTS", raising=False)
    src, models, _ = colmap_scene
    _, tcams, gt = holdout_inputs(src)
    params = tply.load_gaussian_ply(
        str(models["torch"] / "point_cloud" / f"iteration_{ITER}"
            / "point_cloud.ply"), device="cpu")
    with pytest.warns(UserWarning, match="LPIPS weights not found"):
        out = teval.evaluate_holdout(params, tcams, gt, rasterizer="tiled")
    assert "LPIPS" not in out and out["indices"] == [5]


def write_folder(path, images):
    os.makedirs(path)
    for i, img in enumerate(images):
        Image.fromarray((img * 255).astype(np.uint8)).save(
            os.path.join(path, f"{i:05d}.png"))


def test_metrics_over_dirs_matches_jax(colmap_scene, lpips_files, tmp_path):
    src, _, _ = colmap_scene
    _, _, gt = holdout_inputs(src)
    rng = np.random.default_rng(4)
    renders = np.clip(gt[:3] + rng.normal(0, 0.05, gt[:3].shape), 0, 1)
    write_folder(tmp_path / "renders", renders)
    write_folder(tmp_path / "gt", gt[:3])
    out = {}
    for pkg, fn in (("jax", jeval.metrics_over_dirs),
                    ("torch", teval.metrics_over_dirs)):
        out[pkg] = fn(str(tmp_path / "renders"), str(tmp_path / "gt"),
                      out_dir=str(tmp_path / pkg),
                      lpips_weights=lpips_files["alex"])
    assert_scores_close(out["torch"], out["jax"])
    assert_json_close(tmp_path / "torch", tmp_path / "jax")


def assert_json_close(dir_t, dir_j):
    """``results.json`` and ``per_view.json`` of two packages."""
    for name in ("results.json", "per_view.json"):
        with open(os.path.join(dir_t, name)) as f:
            t = json.load(f)
        with open(os.path.join(dir_j, name)) as f:
            j = json.load(f)
        assert sorted(t) == sorted(j)
        if name == "results.json":
            assert_scores_close(t, j)
            continue
        for metric in j:
            assert sorted(t[metric]) == sorted(j[metric])
            for view in j[metric]:
                assert_scores_close({metric: t[metric][view]},
                                    {metric: j[metric][view]})


def printed(text):
    """The ``[SSIM .. PSNR ..( LPiPS ..)]`` lines of ``text`` as tuples of
    floats."""
    return [tuple(float(x) for x in m.groups() if x is not None)
            for m in LINE.finditer(text)]


def assert_lines_close(got, want):
    """Printed values agree to their last printed digit (4 decimals for
    SSIM and LPIPS, 2 for PSNR)."""
    assert len(got) == len(want) and all(len(g) == len(w) for g, w in zip(got, want))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0], w[0], atol=1.01e-4)
        np.testing.assert_allclose(g[1], w[1], atol=1.01e-2)
        if len(w) == 3:
            np.testing.assert_allclose(g[2], w[2], atol=1.01e-4)


def test_cli_evaluate_matches_jax(colmap_scene, lpips_files, capsys):
    _, models, _ = colmap_scene
    args = ["--save_images", "--lpips_weights", lpips_files["alex"]]
    assert jevaluate.main(["-m", str(models["jax"]), *args]) == 0
    want = printed(capsys.readouterr().out)
    assert tevaluate.main(["-m", str(models["torch"]), *args,
                           "--device", "cpu"]) == 0
    got = printed(capsys.readouterr().out)
    assert len(got) == 1 and len(got[0]) == 3
    assert_lines_close(got, want)
    assert_pngs_close(models["jax"] / "images", models["torch"] / "images",
                      ["sim_00005.png", "real_00005.png"])


def test_cli_evaluate_e2vid_matches_jax(colmap_scene, capsys):
    """``--e2vid`` scores an outside folder at the holdout indices: here
    the scene's ``images_event/`` frames, shifted by one view."""
    src, models, _ = colmap_scene
    folder = src.parent / "e2vid"
    if not folder.exists():
        shutil.copytree(src / "images_event", folder)
        os.rename(folder / "r_00000.png", folder / "r_99999.png")
    assert jevaluate.main(["-m", str(models["jax"]), "--e2vid", str(folder)]) == 0
    want = capsys.readouterr().out
    assert tevaluate.main(["-m", str(models["torch"]), "--e2vid", str(folder),
                           "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert "(e2vid)" in got and "(e2vid)" in want
    assert_lines_close(printed(got), printed(want))



def test_cli_evaluate_without_renders_returns_1(colmap_scene, tmp_path, capsys):
    src, _, params = colmap_scene
    bare = tmp_path / "scene"
    shutil.copytree(src, bare, ignore=shutil.ignore_patterns("renders"))
    for pkg, main, extra in (("jax", jevaluate.main, []),
                             ("torch", tevaluate.main, ["--device", "cpu"])):
        write_model(tmp_path / pkg, bare, params)
        assert main(["-m", str(tmp_path / pkg), *extra]) == 1
        assert "no renders/ ground-truth folder found" in capsys.readouterr().out


def test_cli_metrics_matches_jax(colmap_scene, lpips_files, tmp_path, capsys):
    """Each package renders the test set (PNGs within 1 LSB); then both
    score the JAX package's folders, so the metrics see the same inputs."""
    _, models, _ = colmap_scene
    for pkg, render, extra in (("jax", jrender_main, []),
                               ("torch", trender_main, ["--device", "cpu"])):
        shutil.copytree(models[pkg], tmp_path / pkg)
        assert render(["-m", str(tmp_path / pkg), "--skip_train", *extra]) == 0
    assert_pngs_close(tmp_path / "jax" / "test" / f"ours_{ITER}" / "renders",
                      tmp_path / "torch" / "test" / f"ours_{ITER}" / "renders",
                      [f"{i:05d}.png" for i in range(VIEWS)])
    shutil.copytree(tmp_path / "jax", tmp_path / "scored_by_torch")
    capsys.readouterr()
    runs = {}
    for pkg, metrics, model, extra in (
            ("jax", jmetrics.main, tmp_path / "jax", []),
            ("torch", tmetrics.main, tmp_path / "scored_by_torch",
             ["--device", "cpu"])):
        assert metrics(["-m", str(model), str(tmp_path / "none"),
                        "--lpips_weights", lpips_files["alex"], *extra]) == 0
        runs[pkg] = capsys.readouterr().out.replace(str(model), "<model>")
    assert_json_close(tmp_path / "scored_by_torch", tmp_path / "jax")
    # the same lines: the method, the three metrics, the skipped path
    assert [l.split(":")[0] for l in runs["torch"].splitlines()] == \
        [l.split(":")[0] for l in runs["jax"].splitlines()]
    assert "no test/ directory, skipping" in runs["torch"]


def test_cli_full_eval_matches_jax(colmap_scene, lpips_files, tmp_path, capsys,
                                   monkeypatch):
    """Train (2 gray iterations), render, evaluate and metrics in one
    process; LPIPS weights from ``$EVENT3DGS_LPIPS_WEIGHTS``."""
    src, _, _ = colmap_scene
    monkeypatch.setenv("EVENT3DGS_LPIPS_WEIGHTS", lpips_files["alex"])
    args = ["--scenes", str(src), "--iterations", "2", "--gray"]
    assert jfull_eval.main([*args, "--output_path", str(tmp_path / "jax")]) == 0
    want = printed(capsys.readouterr().out)
    assert tfull_eval.main([*args, "--output_path", str(tmp_path / "torch"),
                            "--device", "cpu"]) == 0
    got = printed(capsys.readouterr().out)
    assert len(got) == 1 and len(got[0]) == 3
    assert_lines_close(got, want)
    name = os.path.basename(str(src))
    j, t = tmp_path / "jax" / name, tmp_path / "torch" / name
    for sub in ("train", "test"):
        assert_pngs_close(j / sub / "ours_2" / "renders",
                          t / sub / "ours_2" / "renders",
                          [f"{i:05d}.png" for i in range(VIEWS)])
    assert_json_close(t, j)
    for path in ("cfg.json", "cameras.json", "input.ply", "results.json",
                 "per_view.json", "point_cloud/iteration_2/point_cloud.ply"):
        assert (t / path).exists() and (j / path).exists(), path
