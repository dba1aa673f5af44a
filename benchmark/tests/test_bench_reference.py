"""The plain reference agrees with the port's plain path at a tiny size on
the CPU: a render, and a train step in each mode (in event mode also with
the contrast at or past 0)."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import program
from benchmark.reference import splats
from benchmark.reference import train as ref
from benchmark.scenes import recipes, targets
from benchmark.tests.tiny import ROOT, TINY

CPU = torch.device("cpu")


def tiny_config(name: str) -> dict:
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    cut = TINY[name]
    cfg.update(slots=cut["slots"], width=cut["width"], height=cut["height"])
    cfg["trajectory"]["views"] = cut["views"]
    return cfg


@pytest.mark.parametrize("view", [0, 3, 7])
def test_render_matches_the_port(view):
    from event3dgs_tpu_torch.tools.render_products import _render_view

    cfg = tiny_config("rgb_3m")
    raw = recipes.cloud(cfg, 11, CPU)
    views = recipes.views(cfg, CPU)
    bg = torch.tensor([0.1, 0.2, 0.3])
    ours = splats.render(raw, splats.camera(views, view), bg)
    with torch.no_grad():
        port = _render_view(program.gaussians(raw), program.cameras(views)[view],
                            3, bg, "tiled")
    assert ours.shape == port.shape
    assert float((ours - port).abs().max()) < 1e-5


@pytest.mark.parametrize("name,contrast", [("event_gray_2m", 0.17), ("event_gray_2m", -0.02),
                                           ("event_gray_2m", -0.2), ("rgb_3m", 0.17)])
def test_train_step_matches_the_port(name, contrast, tmp_path):
    from event3dgs_tpu_torch.models.optimizer import AdamState
    from event3dgs_tpu_torch.train.state import SceneData, init_train_state
    from event3dgs_tpu_torch.train.step import make_train_step
    from event3dgs_tpu_torch.utils.config import TrainConfig

    cfg = tiny_config(name)
    mode = cfg["mode"]
    raw = recipes.cloud(cfg, 12, CPU)
    views = recipes.views(cfg, CPU)
    images = targets.targets(tmp_path, cfg, 13, CPU)  # another world's renders
    ev_images = images.flip(0).contiguous()
    shapes = {k: tuple(v.shape) for k, v in raw.items()}
    moments = recipes.adam_moments(cfg, 12, dict(shapes, contrast=()), CPU)
    start, idx, extent = 15000, 4, recipes.nerfpp_extent(views)
    cams = program.cameras(views)
    data = SceneData(cameras=cams, images=images,
                     event_cameras=cams if mode == "event" else None,
                     event_images=ev_images if mode == "event" else None)
    state = init_train_state(program.gaussians({k: v.clone() for k, v in raw.items()}),
                             extent, contrast_init=contrast)
    count = lambda: torch.tensor(start, dtype=torch.int32)
    c_mu, c_nu = moments["contrast"]
    state = state.replace(
        opt_state=AdamState(mu={k: moments[k][0] for k in ref.LEAVES},
                            nu={k: moments[k][1] for k in ref.LEAVES}, count=count()),
        contrast_opt=AdamState(mu=c_mu, nu=c_nu, count=count()),
        step=torch.tensor(start, dtype=torch.int32))
    tc = TrainConfig()
    step = make_train_step(mode, tc.optimization, tc.event, 3, extent, "tiled")
    new, metrics = step(state, data, idx, idx, idx + 1, torch.zeros(3))

    scene = {"cameras": views, "images": images, "event_cameras": views,
             "event_images": ev_images}
    st = ref.State(params=raw, mu={k: moments[k][0] for k in ref.LEAVES},
                   nu={k: moments[k][1] for k in ref.LEAVES}, count=start,
                   stats={k: torch.zeros(cfg["slots"]) for k in
                          ("grad_accum", "denom", "max_radii2d")},
                   contrast=torch.tensor(contrast), c_mu=c_mu, c_nu=c_nu)
    st, loss, grads, _ = ref.step(st, mode, scene, idx, torch.zeros(3),
                                  start + 1, extent)
    assert abs(float(loss) - float(metrics["loss"])) <= 1e-5 * abs(float(loss))
    for k in ref.LEAVES:
        d = float((getattr(new.params, k) - st.params[k]).norm())
        moved = float((st.params[k] - raw[k]).norm())
        assert d <= 1e-4 * max(moved, 1e-12), k
    assert float((new.stats.grad_accum - st.stats["grad_accum"]).abs().max()) <= \
        1e-4 * float(st.stats["grad_accum"].abs().max())
    assert torch.equal(new.stats.denom, st.stats["denom"])
    if mode == "event":
        assert abs(float(new.contrast) - float(st.contrast)) <= 1e-6


def test_tiny_sizes_are_real_work():
    cfg = tiny_config("event_gray_2m")
    raw = recipes.cloud(cfg, 3, CPU)
    means, feats, opac, scales, rots = splats.activated(raw)
    cam = splats.camera(recipes.views(cfg, CPU), 2)
    with torch.no_grad():
        p = splats.project(means, scales, rots, opac, cam)
        f = splats.features(p, splats.sh_colors(feats, means, cam.center), opac)
        lists = splats.tile_lists(p, opac, cam.width, cam.height)
        pairs = splats.pair_counts(f, lists, cam.width, cam.height)
    assert pairs["composited"] > 2 * cam.width * cam.height
    assert 0 < pairs["instances"] <= pairs["listed"]

