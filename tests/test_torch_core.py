"""The port's core math, model container and device rules against the JAX
package (event3dgs_tpu_torch vs event3dgs_tpu), on the CPU."""

import ast
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import event3dgs_tpu.core as jcore
from event3dgs_tpu.models import gaussians as jgauss
import event3dgs_tpu_torch.core as tcore
from event3dgs_tpu_torch.models import gaussians as tgauss

torch.set_num_threads(1)

ATOL = 1e-5  # f32 math in both packages; the port builds cameras in f64
ROOT = pathlib.Path(__file__).resolve().parents[1]


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(b, np.float64),
                               np.asarray(a, np.float64), atol=atol)


def poses(seed, n=3):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    R = np.stack([jcore.quat_to_rotmat(jnp.asarray(qi, jnp.float32))
                  for qi in q]).astype(np.float64)
    t = rng.uniform(-2, 2, (n, 3))
    return R, t


def test_focal_fov_roundtrip():
    for fov, px in [(0.8, 256), (1.2, 1920), (0.6, 97)]:
        assert tcore.fov2focal(fov, px) == pytest.approx(jcore.fov2focal(fov, px))
        f = jcore.fov2focal(fov, px)
        assert tcore.focal2fov(f, px) == pytest.approx(jcore.focal2fov(f, px))


@pytest.mark.parametrize("translate,scale", [(None, 1.0), ([0.3, -0.2, 1.0], 1.7)])
def test_world_to_view_matches(translate, scale):
    R, t = poses(0)
    ref = jcore.world_to_view(R, t, translate=translate, scale=scale)
    out = tcore.world_to_view(R, t, translate=translate, scale=scale)
    close(ref, out.numpy())


def test_perspective_projection_matches():
    fx, fy = np.array([0.7, 1.2]), np.array([0.5, 0.9])
    ref = jcore.perspective_projection(0.01, 100.0, fx, fy)
    close(ref, tcore.perspective_projection(0.01, 100.0, fx, fy).numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_make_and_stack_cameras_match(seed):
    R, t = poses(seed)
    jcams = [jcore.make_camera(R[i], t[i], 1.1, 0.7, 320, 200) for i in range(3)]
    tcams = [tcore.make_camera(R[i], t[i], 1.1, 0.7, 320, 200, device="cpu")
             for i in range(3)]
    jb, tb = jcore.stack_cameras(jcams), tcore.stack_cameras(tcams)
    for f in ("world_view", "full_proj", "camera_center", "tan_fovx", "tan_fovy"):
        close(getattr(jb, f), getattr(tb, f).numpy())
        assert getattr(tb, f).dtype == torch.float32
    assert (tb.width, tb.height, tb.batch_shape) == (320, 200, (3,))
    one = tb[1]
    close(jcams[1].full_proj, one.full_proj.numpy())
    assert one.batch_shape == ()


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_matches(deg):
    rng = np.random.default_rng(deg)
    sh = rng.normal(size=(50, 3, 25)).astype(np.float32)
    dirs = rng.normal(size=(50, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    ref = jcore.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs))
    out = tcore.eval_sh(deg, torch.as_tensor(sh), torch.as_tensor(dirs))
    close(ref, out.numpy())


def test_rgb_sh_conversions_match():
    rgb = np.random.default_rng(3).uniform(0, 1, (10, 3)).astype(np.float32)
    close(jcore.rgb_to_sh(jnp.asarray(rgb)), tcore.rgb_to_sh(torch.as_tensor(rgb)).numpy())
    close(jcore.sh_to_rgb(jnp.asarray(rgb)), tcore.sh_to_rgb(torch.as_tensor(rgb)).numpy())


def random_jax_params(n=40, seed=0, capacity=48):
    rng = np.random.default_rng(seed)
    params = jgauss.init_from_point_cloud(
        rng.uniform(-1, 1, (n, 3)), rng.uniform(0, 1, (n, 3)), capacity
    )
    return params.replace(
        features_rest=jnp.asarray(rng.normal(0, 0.1, (capacity, 15, 3)), jnp.float32),
        rotation=jnp.asarray(rng.normal(size=(capacity, 4)), jnp.float32),
        opacity=jnp.asarray(rng.normal(size=(capacity, 1)), jnp.float32),
    )


def test_params_from_numpy_and_activated_match():
    jp = random_jax_params()
    tp = tgauss.params_from_numpy(
        {f: np.asarray(getattr(jp, f)) for f in tgauss.FIELDS}, device="cpu"
    )
    assert tp.capacity == jp.capacity and tp.sh_coeffs == jp.sh_coeffs
    assert tgauss.num_alive(tp) == int(jgauss.num_alive(jp))
    ja, ta = jgauss.activated(jp), tgauss.activated(tp)
    for f in ta._fields:
        close(getattr(ja, f), getattr(ta, f).numpy())
    # dead slots render with opacity 0
    assert (ta.opacities[~tp.alive] == 0).all()
    with pytest.raises(ValueError):
        tgauss.params_from_numpy({"xyz": np.zeros((1, 3))}, device="cpu")


def test_cuda_without_a_card_raises(monkeypatch):
    from event3dgs_tpu_torch.cli import evaluate, full_eval, generate_dataset, metrics
    from event3dgs_tpu_torch.cli import render as trender
    from event3dgs_tpu_torch.events import accumulate
    from event3dgs_tpu_torch.examples import exr_to_events, images_to_events
    from event3dgs_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        lambda: resolve_device(None),
        lambda: resolve_device("cuda"),
        lambda: tcore.make_camera(np.eye(3), np.zeros(3), 1.0, 0.8, 8, 8),
        lambda: trender.main(["-m", "unused"]),
        lambda: evaluate.main(["-m", "unused"]),
        lambda: metrics.main(["-m", "unused"]),
        lambda: full_eval.main(["--scenes", "unused"]),
        lambda: generate_dataset.main(["--events", "unused", "-o", "unused"]),
        lambda: images_to_events.main(["--images", "unused", "-o", "unused"]),
        lambda: exr_to_events.main(["--exr_dir", "unused", "-o", "unused"]),
        lambda: accumulate.event_count_image([0], [0], [1], 4, 4),
    ):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _path_strings(path):
    """The string constants of ``path`` that are not docstrings."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = set()
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)):
            docs.add(id(body[0].value))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs):
            yield node.value


def test_port_never_imports_jax_or_the_jax_package():
    """No module of the port (nor ``chip_smoke.py``) imports JAX or the JAX
    package, or names a path inside it (its prebuilt native module, its
    noise histograms): the port reads and builds its own copies."""
    files = sorted((ROOT / "event3dgs_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    scanned = {f.relative_to(ROOT).as_posix() for f in files}
    for module in ("losses/lpips.py", "tools/evaluation.py", "cli/evaluate.py",
                   "cli/metrics.py", "cli/full_eval.py", "events/dvs_model.py",
                   "events/native/__init__.py", "events/accumulate.py",
                   "utils/colorimetry.py", "cli/generate_dataset.py",
                   "examples/compare_streams.py", "parallel/mesh.py",
                   "parallel/collectives.py", "parallel/partition.py",
                   "parallel/compose.py", "parallel/exchange.py",
                   "parallel/sharded_train.py", "parallel/distributed.py",
                   "train/loop_sharded.py", "train/network_gui.py",
                   "data/synthetic.py", "tools/make_scene.py",
                   "tools/dataset_prep.py", "cli/convert.py"):
        assert f"event3dgs_tpu_torch/{module}" in scanned, module
    banned = ("jax", "flax", "event3dgs_tpu")
    bad = [
        (str(f.relative_to(ROOT)), m)
        for f in files
        for m in _imported_modules(f)
        if m.split(".")[0] in banned
    ]
    assert not bad, bad
    jax_path = re.compile(r"(^|[/\\])event3dgs_tpu($|[/\\])|dvs_native\.cpython")
    citation = re.compile(r"^[\w/.]+\.py:\d+$")  # "file:line" of a TPU kernel
    named = [(str(f.relative_to(ROOT)), v) for f in files
             for v in _path_strings(f)
             if jax_path.search(v) and not citation.match(v)]
    assert not named, named
    assert jax_path.search("x/event3dgs_tpu/data/noise")
    assert citation.match("event3dgs_tpu/ops/expand.py:65")
    assert jax_path.search("event3dgs_tpu") and not jax_path.search("event3dgs_tpu_torch/x")
