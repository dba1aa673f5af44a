"""Gradients of the port's tiled rasterizer (binning + K1 forward, K2 + K3
backward, plain versions on the CPU) against the JAX tiled rasterizer
(Pallas kernels in interpret mode) and against both oracles, on
tests/test_rasterize_tiled.py's scenes.

Tolerances are the JAX suite's: gradients max-normalised at atol 2e-4, the
background gradient at rtol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event3dgs_tpu.core import make_camera as jmake_camera
from event3dgs_tpu.ops import project_gaussians as jproject
from event3dgs_tpu.ops.rasterize_reference import rasterize_reference as jref
from event3dgs_tpu.ops.rasterize_tiled import rasterize_tiled as jtiled
from event3dgs_tpu_torch.core import make_camera as tmake_camera
from event3dgs_tpu_torch.ops import rasterize_tiled as trt
from event3dgs_tpu_torch.ops.projection import project_gaussians as tproject
from event3dgs_tpu_torch.ops.rasterize_reference import rasterize_reference as tref

torch.set_num_threads(1)

ARGS = ("means", "scales", "rots", "opac", "colors")


def scene(n=80, seed=0, w=256, h=64, spread=1.2, scale=(0.03, 0.25)):
    """tests/test_rasterize_tiled.py's scene, as numpy arrays."""
    rng = np.random.default_rng(seed)
    means = np.c_[rng.uniform(-spread, spread, n),
                  rng.uniform(-spread * 0.4, spread * 0.4, n),
                  rng.uniform(2.0, 6.0, n)]
    scales = (np.exp(rng.uniform(np.log(scale[0]), np.log(scale[1]), (n, 1)))
              * rng.uniform(0.7, 1.4, (n, 3)))
    rots = rng.normal(size=(n, 4))
    opac = rng.uniform(0.2, 0.95, n)
    colors = rng.uniform(0.0, 1.0, (n, 3))
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(w=w, h=h, means=f32(means), scales=f32(scales), rots=f32(rots),
                opac=f32(opac), colors=f32(colors), bg=f32([0.1, 0.2, 0.3]),
                wgt=f32(np.random.default_rng(7).uniform(-1, 1, (h, w, 3))))


def jax_grads(s, raster, **kw):
    cam = jmake_camera(np.eye(3), np.zeros(3), 1.0, 0.8, s["w"], s["h"])

    def loss(m, sc, r, o, c):
        proj = jproject(m, sc, r, cam)
        img = raster(proj, c, o, jnp.asarray(s["bg"]), s["w"], s["h"], **kw)
        return jnp.sum(img * s["wgt"])

    g = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(s[k]) for k in ARGS))
    return [np.asarray(x) for x in g]


def torch_grads(s, raster, **kw):
    cam = tmake_camera(np.eye(3), np.zeros(3), 1.0, 0.8, s["w"], s["h"],
                       device="cpu")
    leaves = [torch.tensor(s[k], requires_grad=True) for k in ARGS]
    m, sc, r, o, c = leaves
    img = raster(tproject(m, sc, r, cam), c, o, torch.tensor(s["bg"]),
                 s["w"], s["h"], **kw)
    g = torch.autograd.grad((img * torch.tensor(s["wgt"])).sum(), leaves)
    return [x.numpy() for x in g]


def assert_grads_close(got, ref, atol=2e-4):
    for name, a, b in zip(ARGS, got, ref):
        assert np.isfinite(a).all(), name
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def simple_grads():
    """tests/test_rasterize_tiled.py's gradient scene (n=40 at 128×48):
    the port's tiled and oracle gradients, the JAX tiled and oracle ones."""
    s = scene(n=40, seed=3, w=128, h=48)
    return dict(port=torch_grads(s, trt.rasterize_tiled),
                port_oracle=torch_grads(s, tref),
                jax=jax_grads(s, jtiled),
                jax_oracle=jax_grads(s, jref))


@pytest.mark.parametrize("ref", ["jax", "jax_oracle", "port_oracle"])
@pytest.mark.parametrize("arg", ARGS)
def test_tiled_gradients_match(simple_grads, ref, arg):
    i = ARGS.index(arg)
    assert_grads_close([simple_grads["port"][i]], [simple_grads[ref][i]])


def test_background_gradient_matches_oracles():
    s = scene(n=20, seed=4, w=128, h=48)
    outs = {}
    for name, fn in (("port", trt.rasterize_tiled), ("port_oracle", tref)):
        cam = tmake_camera(np.eye(3), np.zeros(3), 1.0, 0.8, s["w"], s["h"],
                           device="cpu")
        proj = tproject(*(torch.tensor(s[k]) for k in ("means", "scales", "rots")),
                        cam)
        bg = torch.tensor(s["bg"], requires_grad=True)
        img = fn(proj, torch.tensor(s["colors"]), torch.tensor(s["opac"]), bg,
                 s["w"], s["h"])
        outs[name] = torch.autograd.grad((img ** 2).sum(), [bg])[0].numpy()
    jcam = jmake_camera(np.eye(3), np.zeros(3), 1.0, 0.8, s["w"], s["h"])
    jp = jproject(*(jnp.asarray(s[k]) for k in ("means", "scales", "rots")), jcam)
    jg = jax.grad(lambda b: jnp.sum(jref(jp, jnp.asarray(s["colors"]),
                                         jnp.asarray(s["opac"]), b, s["w"],
                                         s["h"]) ** 2))(jnp.asarray(s["bg"]))
    np.testing.assert_allclose(outs["port"], np.asarray(jg), rtol=1e-3)
    np.testing.assert_allclose(outs["port"], outs["port_oracle"], rtol=1e-3)


def test_dense_opaque_gradients_match_jax():
    """Many overlapping near-opaque Gaussians: pixels saturate, so the
    backward walk must start at each pixel's stop index.  Against the JAX
    tiled rasterizer, which also stops at ln 1e-6 (the oracle stops at
    T < 1e-4 and differs by more)."""
    s = scene(n=150, seed=1, w=256, h=64, spread=0.3)
    assert_grads_close(torch_grads(s, trt.rasterize_tiled),
                       jax_grads(s, jtiled))


def test_overflow_gradients_match_jax():
    """Cap 1024 with ~2.5k instances: both packages keep the first 1024
    instances in depth order; the dropped ones get no gradient."""
    s = scene(n=200, seed=5, w=256, h=64, scale=(0.1, 0.4))
    port = torch_grads(s, trt.rasterize_tiled, instance_cap=1024)
    assert_grads_close(port, jax_grads(s, jtiled, instance_cap=1024))
    full = torch_grads(s, trt.rasterize_tiled)
    assert max(np.abs(a - b).max() for a, b in zip(port, full)) > 0
