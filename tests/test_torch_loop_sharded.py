"""The port's sharded training loop and the multi-rank ``cli.train`` on gloo
ranks on the CPU (the counterpart of tests/test_parallel.py's loop tests
and tests/test_distributed.py).

- ``train_loop_sharded`` at data 2 × gauss 2 against JAX's on a 4-device
  mesh: the same views (``random.Random(seed)``), loss history within rel
  1e-5 up to the first densify (the densify split samples differ by
  framework); the port's run crosses the densify and grows, and every rank
  ends with the same state (data replicas never diverge).
- On a world of one rank the sharded loop reproduces ``train_loop`` bit
  for bit through two densify passes (the CPU twin of chip_smoke's
  phase 11 check).
- ``cli.train --mesh_data 2 --mesh_gauss 2 --device cpu`` trains a tiny
  scene through densify; its PLY and checkpoint load in both packages; the
  same job split over two hosts (``--coordinator --num_processes 2
  --process_id i``, two ranks each) writes bit-identical files.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_rank_worker as worker
from event3dgs_tpu.data.ply import load_gaussian_ply as jload_ply
from event3dgs_tpu.data.synthetic import make_synthetic_scene as jscene
from event3dgs_tpu.models import init_from_point_cloud as jinit
from event3dgs_tpu.parallel import make_mesh as jmake_mesh
from event3dgs_tpu.train import SceneData as JSceneData
from event3dgs_tpu.train import init_train_state as jinit_state
from event3dgs_tpu.train import train_loop_sharded as jloop_sharded
from event3dgs_tpu.train.checkpoint import load_checkpoint as jload_ckpt
from event3dgs_tpu.utils.config import TrainConfig as JTrainConfig
from event3dgs_tpu_torch.cli import train as ttrain
from event3dgs_tpu_torch.data.ply import load_gaussian_ply
from event3dgs_tpu_torch.models import init_from_point_cloud
from event3dgs_tpu_torch.tools.make_scene import synthesize_scene
from event3dgs_tpu_torch.train import init_train_state
from event3dgs_tpu_torch.train.checkpoint import load_checkpoint

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ITERS = 12
CLI_ARGS = ["--gray", "--event", "-r", "1", "-w", "--iterations", str(ITERS),
            "--densify_from_iter", "2", "--densification_interval", "4",
            "--densify_grad_threshold", "1e-7", "--save_iterations", str(ITERS),
            "--checkpoint_iterations", str(ITERS), "--device", "cpu",
            "--mesh_data", "2", "--mesh_gauss", "2", "--quiet"]


@pytest.fixture(scope="module")
def loop_ranks(tmp_path_factory):
    return worker.spawn(tmp_path_factory.mktemp("loop4"), 4, ["loop"])


def test_loop_sharded_matches_jax_until_densify(loop_ranks):
    scene = jscene(40, 12, 64, 48, arc=0.5)
    state = jinit_state(jinit(scene.points, scene.colors, capacity=64),
                        spatial_lr_scale=scene.extent)
    data = JSceneData(cameras=scene.cameras, images=scene.images,
                      event_cameras=scene.cameras, event_images=scene.images)
    cfg = JTrainConfig()
    cfg.pipeline.rasterizer = "tiled"
    cfg.optimization.densify_from_iter = 4
    cfg.optimization.densification_interval = 8
    cfg.optimization.densify_grad_threshold = 1e-7
    # two steps of B = 4 views; the densify at view 8 follows the second
    res = jloop_sharded(state, data, cfg, "event", scene.extent,
                        jmake_mesh(4, gauss=2), iterations=8)
    loop = loop_ranks[0]["loop"]
    np.testing.assert_allclose(loop["history"][:2], res.history, rtol=1e-5)
    assert np.isfinite(loop["history"]).all() and len(loop["history"]) == 3
    assert loop["step"] == ITERS
    # one densify, at view 8, and clone/split added Gaussians
    alive = [(it, m["num_alive"]) for it, m in loop["metrics"]
             if "num_alive" in m]
    assert alive == [(8, int(loop["alive"].sum()))] and alive[0][1] > 40


def test_loop_ranks_end_with_one_state(loop_ranks):
    first = loop_ranks[0]["loop"]
    for res in loop_ranks[1:]:
        got = res["loop"]
        assert got["history"] == first["history"]
        assert torch.equal(got["alive"], first["alive"])
        for f, t in got["params"].items():
            assert torch.equal(t, first["params"][f]), f


def test_world_one_loop_reproduces_train_loop(tmp_path):
    res = worker.spawn(tmp_path, 1, ["loop_world1"])[0]["loop_world1"]
    assert len(res["plain"]) == 7 and res["alive"] > 40
    assert res["sharded"] == res["plain"]
    assert torch.equal(res["sharded_xyz"], res["plain_xyz"])


@pytest.fixture(scope="module")
def tiny_scene(tmp_path_factory):
    src = tmp_path_factory.mktemp("tiny") / "scene"
    synthesize_scene(str(src), n_views=8, width=48, height=48,
                     n_gaussians=60, white_background=True, device="cpu")
    return src


@pytest.fixture(scope="module")
def one_host(tiny_scene, tmp_path_factory):
    model = tmp_path_factory.mktemp("one_host") / "model"
    assert ttrain.main(["-s", str(tiny_scene), "-m", str(model)]
                       + CLI_ARGS) == 0
    return model


def test_cli_mesh_trains_through_densify_and_loads_in_both_packages(one_host):
    ply = one_host / "point_cloud" / f"iteration_{ITERS}" / "point_cloud.ply"
    ck_path = one_host / f"chkpnt{ITERS}.npz"
    ck = np.load(ck_path)
    assert int(ck["step"]) == ITERS
    alive = ck["params/alive"]
    assert alive.sum() > 60  # the densify passes added Gaussians
    assert np.isfinite(ck["params/xyz"]).all()
    jp = jload_ply(str(ply), max_sh_degree=3)
    tp = load_gaussian_ply(str(ply), max_sh_degree=3, device="cpu")
    assert int(jp.alive.sum()) == int(tp.alive.sum()) == int(alive.sum())
    np.testing.assert_array_equal(np.asarray(jp.xyz), tp.xyz.numpy())
    np.testing.assert_array_equal(tp.xyz.numpy()[:int(alive.sum())],
                                  ck["params/xyz"][alive])

    cap = alive.shape[0]
    pts, cols = np.zeros((1, 3)), np.full((1, 3), 0.5)
    jstate, jit_ = jload_ckpt(str(ck_path), jinit_state(jinit(pts, cols, cap),
                                                        1.0))
    tstate, tit = load_checkpoint(str(ck_path), init_train_state(
        init_from_point_cloud(pts, cols, cap, device="cpu"), 1.0))
    assert jit_ == tit == ITERS
    np.testing.assert_array_equal(np.asarray(jstate.params.xyz),
                                  tstate.params.xyz.numpy())
    assert float(tstate.contrast) != 0.17


def test_two_hosts_bit_equal_one_host(tiny_scene, one_host, tmp_path):
    model = tmp_path / "model"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    cmd = [sys.executable, "-m", "event3dgs_tpu_torch.cli.train",
           "-s", str(tiny_scene), "-m", str(model), *CLI_ARGS,
           "--coordinator", f"file://{tmp_path / 'rendezvous'}",
           "--num_processes", "2"]
    hosts = [subprocess.Popen(cmd + ["--process_id", str(i)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for i in range(2)]
    outs = []
    try:
        for p in hosts:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in hosts:
            p.kill()
    for p, out in zip(hosts, outs):
        assert p.returncode == 0, out[-3000:]
    a, b = np.load(one_host / f"chkpnt{ITERS}.npz"), np.load(
        model / f"chkpnt{ITERS}.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    ply = Path("point_cloud") / f"iteration_{ITERS}" / "point_cloud.ply"
    assert (one_host / ply).read_bytes() == (model / ply).read_bytes()
