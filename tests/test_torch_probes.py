"""The port's kernel probes (``tools/kernel_probes.py``) on the CPU: the
catalogue of K1, K4 and SSIM builds and how `ops/kernels.py` names and
compiles them, K1's stop statistics against a loop over pixels, the event
step's cumulative stages against the port's own functions, the plain
dynamic-grid sum, the bound arithmetic of ``tools/kernel_timing.py``, the
replay split's grouping and stage markers (``tools/step_split.py``) and
the command line.  Imports no JAX."""

import hashlib
import json
import re

import numpy as np
import pytest
import torch

from event3dgs_tpu_torch.ops import binning, kernels, segscan
from event3dgs_tpu_torch.ops import rasterize_tiled as rt
from event3dgs_tpu_torch.tools import kernel_probes as kp
from event3dgs_tpu_torch.tools import kernel_timing as kt
from event3dgs_tpu_torch.tools import step_split as ss
from test_torch_kernels import scene

torch.set_num_threads(1)

K1_NAMES = ["base", "noexp", "nolog", "nocull", "nocopy", "nostop", "nospill",
            "clock"]
K4_NAMES = ["base", "nochain", "nostage", "nocull", "nocount", "nostore"]


def test_variant_catalogue():
    assert list(kp.K1_VARIANTS) == K1_NAMES
    assert list(kp.K4_VARIANTS) == K4_NAMES
    for table in (kp.K1_VARIANTS, kp.K4_VARIANTS):
        assert table["base"].defines == () and not table["base"].timing_only
    assert kp.K1_VARIANTS["nolog"].defines == ("E3D_NOEXP", "E3D_NOLOG")
    assert not kp.K1_VARIANTS["clock"].timing_only
    assert kp.K4_VARIANTS["nocount"].defines == ()
    assert not kp.K4_VARIANTS["nocount"].count_rows
    assert all(v.timing_only for v in kp.variants()
               if v.name not in ("base", "clock"))
    # every macro is one its source tests
    for v in kp.variants():
        text = (kernels.CSRC / f"{v.source}.cu").read_text()
        for d in v.defines:
            assert re.search(rf"#if(n?def| defined\()\s*{d}\b", text), (v.label, d)
    assert set(kp.variant_builds()) == {
        (v.source, v.defines) for v in kp.variants()}
    assert ("rasterize_fwd", ()) in kp.variant_builds()


def test_depth_order_builds_catalogue():
    """The depth order's timing-only builds: ``base`` the shipping library,
    every other macro one that ``csrc/depth_sort.cu`` tests; the kernels
    whose registers the probe reads are in that source; the probe needs
    the card; the replay split counts the sort's kernels in the binning."""
    assert list(kp.OFFSETS_VARIANTS) == ["base", "nogather", "nolookback",
                                         "noclear"]
    assert kp.OFFSETS_VARIANTS["base"][0] == ()
    text = (kernels.CSRC / "depth_sort.cu").read_text()
    for defines, _ in kp.OFFSETS_VARIANTS.values():
        for d in defines:
            assert re.search(rf"#if(n?def| defined\()\s*{d}\b", text), d
    assert kp.offsets_builds() == [
        ("depth_sort", d) for d, _ in kp.OFFSETS_VARIANTS.values()]
    assert kernels.library_path(*kp.offsets_builds()[0]) == \
        kernels.library_path("depth_sort")
    # the pass kernel's two instances: SORT_ITEMS and SORT_ITEMS_SMALL keys
    # a thread
    for function, _ in kp.DEPTH_FUNCTIONS:
        assert f"{function}(" in text
    assert [t for _, t in kp.DEPTH_FUNCTIONS if t] == ["ILi16E", "ILi8E"]
    assert "constexpr int SORT_ITEMS = 16;" in text
    assert "constexpr int SORT_ITEMS_SMALL = 8;" in text
    assert "offsets" in kp.MODES and "offsets" in kp.CARD_MODES
    for name in ("radix_histogram_kernel", "radix_pass_kernel",
                 "depth_offsets_kernel"):
        assert ss.split_group(name, "rasterizer fwd") == "binning kernels"


def _shipping_path(name):
    """The library path as `ops/kernels.py` computed it before builds took
    macros."""
    h = hashlib.sha256()
    for path in kernels.sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(kernels.NVCC_FLAGS).encode())
    return kernels.BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def test_library_paths_of_the_builds():
    for name in kernels.SIGNATURES:
        assert kernels.library_path(name) == _shipping_path(name)
        assert kernels.library_path(name, ()) == _shipping_path(name)
    paths = {kernels.library_path(v.source, v.defines) for v in kp.variants()}
    # base and nocount share the shipping K4; base is the shipping K1
    assert len(paths) == len(kp.variants()) - 1
    assert kernels.library_path("rasterize_fwd", ("E3D_NOEXP",)).name.startswith(
        "librasterize_fwd+E3D_NOEXP_")
    assert kernels.library_path("expand", ("E3D_K4_NOCULL",)) != \
        kernels.library_path("expand")
    assert kernels.build_key("rasterize_fwd", ("E3D_NOEXP", "E3D_NOLOG")) == \
        "rasterize_fwd+E3D_NOEXP+E3D_NOLOG"
    with pytest.raises(ValueError, match="not a macro"):
        kernels.library_path("rasterize_fwd", ("X; rm",))


def test_build_starts_one_nvcc_per_build_with_its_macros(tmp_path, monkeypatch):
    started = []

    class FakeNvcc:
        def __init__(self, cmd, **kw):
            started.append(cmd)
            out = cmd[cmd.index("-o") + 1]
            open(out, "w").write("")
            self.returncode = 0

        def communicate(self):
            return "ptxas info    : Used 1 registers\n", None

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kernels.subprocess, "Popen", FakeNvcc)
    logs = kernels.build(["segsum", *kp.variant_builds()])
    assert len(started) == len(kp.variant_builds()) + 1  # all started together
    flags = {tuple(a[2:] for a in cmd if a.startswith("-D")) for cmd in started}
    assert flags == {v.defines for v in kp.variants()}
    assert set(logs) == {"segsum"} | {kernels.build_key(s, d)
                                      for s, d in kp.variant_builds()}
    for s, d in kp.variant_builds():
        assert kernels.library_path(s, d).exists()
    started.clear()
    kernels.build(kp.variant_builds())  # cached: nothing rebuilt
    assert started == []


SSIM_NAMES = ["base", "nostage", "novert", "nohoriz", "nostore"]


def test_ssim_variant_catalogue():
    """The SSIM builds: base is the shipping library, every other build's
    macros are ones ``csrc/ssim.cu`` tests, each build its own library; the
    probe's launches count per kernel and refuse CPU tensors uncounted."""
    assert list(kp.SSIM_VARIANTS) == SSIM_NAMES
    base = kp.SSIM_VARIANTS["base"]
    assert base.defines == () and not base.timing_only
    assert kernels.library_path(base.source) == _shipping_path("ssim")
    text = (kernels.CSRC / "ssim.cu").read_text()
    for v in kp.SSIM_VARIANTS.values():
        assert v.source == "ssim" and v.label == f"SSIM {v.name}"
        assert v.timing_only == (v.name != "base")
        for d in v.defines:
            assert re.search(rf"#if(n?def| defined\()\s*{d}\b", text), (v.name, d)
    assert kp.ssim_builds() == sorted(
        ("ssim", v.defines) for v in kp.SSIM_VARIANTS.values())
    assert len({kernels.library_path(s, d) for s, d in kp.ssim_builds()}) == \
        len(SSIM_NAMES)
    assert "ssim" in kp.MODES and "ssim" in kp.CARD_MODES
    render, gt, bg = kp.ssim_operands(6, 9, "cpu")
    v = kp.SSIM_VARIANTS["nostage"]
    before = dict(v.launches)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        v.forward(render, gt, 0.2, False, bg)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        v.backward(torch.ones(()), render, gt, None, 0.2, False, bg)
    assert v.launches == before == {"forward": 0, "backward": 0}
    assert kp.max_abs_err([torch.tensor([1.0, float("nan")])],
                          [torch.tensor([0.5, 0.0])]) == kp.FLOAT32_MAX
    assert kp.max_abs_err([torch.tensor([1.0])], [torch.tensor([0.25])]) == 0.75


def test_variant_functions_are_declared():
    # the clock function exists only in the E3D_CLOCK build of K1; the
    # shipping library is never asked for it
    assert "e3d_composite_forward_clock" in kernels.SIGNATURES["rasterize_fwd"]
    text = (kernels.CSRC / "rasterize_fwd.cu").read_text()
    head = text.index('extern "C" int e3d_composite_forward_clock(')
    assert text.rfind("#ifdef E3D_CLOCK", 0, head) > text.rfind(
        "#endif", 0, head)
    assert "e3d_dyngrid_sum" in kernels.SIGNATURES["probes"]


def stop_statistics_loop(stop, counts, width, height):
    """stop_statistics over the pixels one at a time."""
    tiles_x = -(-width // 32)
    early_px, evaluated, unevaluated = 0, 0, 0
    sub_all, tile_all = {}, {}
    for y in range(height):
        for x in range(width):
            t = (y // 32) * tiles_x + x // 32
            s = (t, (y % 32) // 8, (x % 32) // 16)
            e = stop[y, x] < counts[t]
            early_px += e
            evaluated += stop[y, x]
            unevaluated += max(counts[t] - stop[y, x], 0)
            sub_all[s] = sub_all.get(s, True) and e
            tile_all[t] = tile_all.get(t, True) and e
    return {"pixels": width * height, "early_pixels": early_px,
            "sub_blocks": len(sub_all), "early_sub_blocks": sum(sub_all.values()),
            "tiles": len(tile_all), "early_tiles": sum(tile_all.values()),
            "evaluated": evaluated, "unevaluated": unevaluated}


def check_stop_statistics(stop, counts, width, height):
    got = kp.stop_statistics(torch.tensor(stop), torch.tensor(counts), width,
                             height)
    want = stop_statistics_loop(np.asarray(stop), np.asarray(counts), width,
                                height)
    for k, v in want.items():
        assert got[k] == v, k
    assert got["pixel_share"] == want["early_pixels"] / want["pixels"]
    assert got["tile_share"] == want["early_tiles"] / want["tiles"]
    assert got["sub_block_share"] == want["early_sub_blocks"] / want["sub_blocks"]
    return got


def test_stop_statistics_on_the_plain_k1():
    proj, colors, opac, w, h = scene(n=300, seed=1, w=96, h=64, spread=0.4,
                                     opacity=(0.5, 0.99))
    b = binning.bin_gaussians(proj.mean2d, proj.depth, proj.radius, proj.valid,
                              w, h, rt.default_instance_cap(300),
                              opacities=opac, conic=proj.conic)
    feat = rt.pack_features(proj.mean2d, proj.conic, colors, opac)
    _, _, stop = rt.composite_forward_plain(b.inst_gauss, b.tile_offsets,
                                            b.tile_counts, feat, b.num_tiles_x,
                                            w, h)
    got = check_stop_statistics(stop.numpy(), b.tile_counts.numpy(), w, h)
    assert 0 < got["early_pixels"] < w * h  # some pixels stop early
    assert got["unevaluated"] > 0


@pytest.mark.parametrize("case", ["none", "all", "one_tile", "ragged"])
def test_stop_statistics_on_hand_made_stops(case):
    w, h = 80, 40  # 3 × 2 tiles, the last column and row ragged
    counts = np.array([5, 0, 7, 3, 9, 2], np.int32)
    tile = (np.arange(h)[:, None] // 32) * 3 + np.arange(w)[None, :] // 32
    stop = counts[tile].copy()
    if case == "all":
        stop = np.maximum(counts[tile] - 1, 0)
    elif case == "one_tile":  # tile 2 (x 64-79, y 0-31) stops at 0
        stop[tile == 2] = 0
    elif case == "ragged":  # half of tile 4's first sub-block stops early
        stop[32:36, 32:48] = 4
    got = check_stop_statistics(stop, counts, w, h)
    # sub-blocks in the image: 8, 0, 4 (16 columns), 2, 2, 1 (8 rows); tile
    # 1 has no instance, so it never stops early
    want = {"none": (0, 0, 0), "all": (5, 8 + 4 + 2 + 2 + 1, 0),
            "one_tile": (1, 4, 7 * 32 * 16), "ragged": (0, 0, 5 * 16 * 4)}[case]
    assert (got["early_tiles"], got["early_sub_blocks"]) == want[:2]
    if case != "all":
        assert got["unevaluated"] == want[2]


@pytest.fixture(scope="module")
def small_state():
    return kt.bench_state("cpu", n=300, width=96, height=64)


def test_stages_equal_the_ports_own_functions(small_state):
    from event3dgs_tpu_torch.ops.preprocess import masked_features
    from event3dgs_tpu_torch.ops.projection import project_gaussians
    from event3dgs_tpu_torch.ops.render import gaussian_colors, render_partials
    from event3dgs_tpu_torch.train.step import (
        make_loss_and_grads,
        make_train_step,
        step_inputs,
    )
    from event3dgs_tpu_torch.utils.config import EventConfig, OptimizationConfig

    state, data, cap = small_state
    bg = torch.zeros(3)
    stages = kp.event_step_stages(state, data, kp.TRAIN_IDX, bg, cap)
    assert [n for n, _ in stages][0] == "projection" and len(stages) == 7
    out = [fn() for _, fn in stages]
    cam = data.cameras[kp.TRAIN_IDX[0]]
    inp = step_inputs(state)
    act = inp.act
    proj = project_gaussians(act.means3d, act.scales, act.rotations, cam,
                             opacities=act.opacities)
    for field in proj._fields:
        assert torch.equal(getattr(out[0][1], field), getattr(proj, field))
    features = masked_features(inp.leaves["features_dc"],
                               inp.leaves["features_rest"], inp.cmask)
    colors = gaussian_colors(3, features, act.means3d, cam.camera_center)
    assert torch.equal(out[1][2], colors)
    b = binning.bin_gaussians(proj.mean2d.detach(), proj.depth, proj.radius,
                              proj.valid, 96, 64, cap, opacities=act.opacities,
                              conic=proj.conic)
    for field in ("inst_gauss", "tile_offsets", "tile_counts", "dest", "offsets"):
        assert torch.equal(getattr(out[2][3], field), getattr(b, field))
    partials = render_partials(act.means3d, features, act.opacities,
                               act.scales, act.rotations, cam, sh_degree=3,
                               mean2d_tap=inp.tap, rasterizer="tiled",
                               instance_cap=cap)
    assert torch.equal(out[3][1].rgb, partials.rgb)
    assert torch.equal(out[3][1].logt, partials.logt)
    # stage 4's K1 is stage 3's binning composited
    feat = rt.pack_features(proj.mean2d, proj.conic, colors, act.opacities)
    rgb, _, _ = rt.composite_forward_plain(b.inst_gauss, b.tile_offsets,
                                           b.tile_counts, feat, b.num_tiles_x,
                                           96, 64)
    assert torch.equal(out[3][1].rgb, rgb)
    grads = torch.autograd.grad(partials.rgb.sum() + partials.logt.sum(),
                                [*inp.leaves.values(), inp.tap],
                                allow_unused=True)
    assert len(out[4][1]) == len(grads) == 7
    for g_stage, g in zip(out[4][1], grads):
        assert torch.equal(g_stage, g)
    ev = EventConfig()
    loss, _, g6 = make_loss_and_grads("event", ev, ev.event_lambda_dssim,
                                      rasterizer="tiled", instance_cap=cap)(
        state, data, *kp.TRAIN_IDX, bg)
    assert torch.equal(out[5][0], loss)
    for k, g in g6["params"].items():
        assert torch.equal(out[5][2]["params"][k], g)
    assert torch.equal(out[5][2]["tap"], g6["tap"])
    new, metrics = make_train_step("event", OptimizationConfig(), ev,
                                   spatial_lr_scale=3.0, rasterizer="tiled",
                                   instance_cap=cap)(state, data,
                                                     *kp.TRAIN_IDX, bg)
    for field in ("xyz", "features_dc", "features_rest", "scaling", "rotation",
                  "opacity"):
        assert torch.equal(getattr(out[6][0].params, field),
                           getattr(new.params, field))
    assert torch.equal(out[6][0].contrast, new.contrast)
    assert torch.equal(out[6][1]["loss"], metrics["loss"])


def test_stages_mode_on_the_cpu_times_the_host_only(small_state, monkeypatch):
    monkeypatch.setattr(kt, "bench_state", lambda *a, **k: small_state)
    monkeypatch.setattr(kp, "STAGE_CALLS", 1)
    rec = kp.Probes(torch.device("cpu"), 300, 96, 64).run("stages")
    assert [r["stage"] for r in rec["stages"]] == list(range(1, 8))
    assert all("device_us" not in r and r["host_ms"] > 0 for r in rec["stages"])
    assert rec["stages"][1]["added"]["host_ms"] == pytest.approx(
        rec["stages"][1]["host_ms"] - rec["stages"][0]["host_ms"])
    json.dumps(rec)


@pytest.mark.parametrize("n", [0, 1, 3, 7, 100])
def test_dyngrid_plain_sums_the_first_n_blocks_in_order(n):
    x = torch.arange(800 * 128, dtype=torch.float32).reshape(800, 128) % 7
    got = kp.dyngrid_plain(x, n)
    assert got.shape == (8, 128)
    assert torch.equal(got, x.reshape(100, 8, 128)[:n].sum(0)
                       if n else torch.zeros(8, 128))
    ones = kp.dyngrid_plain(torch.ones(800, 128), n)
    assert float(ones.sum()) == n * 1024


@pytest.mark.parametrize("n, like", [(-1, 0), (-100, 0), (101, 100),
                                     (10**6, 100)])
def test_dyngrid_plain_clamps_the_count_like_the_kernel(n, like):
    x = kp.dyngrid_input("cpu")
    assert torch.equal(kp.dyngrid_plain(x, n), kp.dyngrid_plain(x, like))


def test_dyngrid_input_is_seeded_and_order_sensitive():
    x = kp.dyngrid_input("cpu")
    assert x.shape == (800, 128) and x.dtype == torch.float32
    assert torch.equal(x, kp.dyngrid_input("cpu"))
    assert not torch.equal(x, kp.dyngrid_input("cpu", seed=1))
    blocks = x.reshape(100, 8, 128)
    for n in (3, 7, 100):
        forward = kp.dyngrid_plain(x, n)
        backward = kp.dyngrid_plain(blocks[:n].flip(0).reshape(-1, 128), n)
        assert not torch.equal(forward, backward), n
        # the same sum, only rounded differently: within the float32
        # summation bound n·eps·Σ|x|
        bound = n * 2.0**-23 * blocks[:n].abs().sum(0)
        assert bool(((forward - backward).abs() <= bound).all()), n


def test_dyngrid_mode_on_the_cpu():
    rec = kp.dyngrid("cpu")
    assert rec["plain"] == {"3": 3072.0, "7": 7168.0}
    assert rec["expected"] == {"3": 3072, "7": 7168}
    assert rec["order_sensitive"] == {"3": True, "7": True}
    assert "replays" not in rec


def test_dyngrid_kernel_refuses_cpu_tensors():
    x = torch.ones(800, 128)
    before = kp.dyngrid_kernel.launches
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kp.dyngrid_kernel(x, torch.ones(1, dtype=torch.int32),
                          torch.empty_like(x), torch.zeros(1, dtype=torch.int32),
                          torch.empty(8, 128))
    assert kp.dyngrid_kernel.launches == before


def test_command_line(capsys):
    p = kp.build_parser()
    args = p.parse_args(["k1"])
    assert (args.mode, args.device, args.gaussians, args.width, args.height) == (
        "k1", None, 100_000, 1920, 1080)
    args = p.parse_args(["all", "--device", "cpu", "--gaussians", "300",
                         "--width", "96", "--height", "64"])
    assert (args.mode, args.gaussians, args.width, args.height) == (
        "all", 300, 96, 64)
    with pytest.raises(SystemExit):
        p.parse_args(["nosuchmode"])
    for mode in kp.CARD_MODES:
        with pytest.raises(SystemExit, match="needs a CUDA card"):
            kp.main([mode, "--device", "cpu", "--gaussians", "30", "--width",
                     "64", "--height", "32"])
    assert kp.main(["dyngrid", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-2])["mode"] == "dyngrid"
    assert lines[-1].startswith("cpu: no card")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            kp.main(["dyngrid"])


def test_bound_arithmetic():
    pairs = [10, 20, 30, 5]
    assert kt.pair_ops(pairs, kt.K1_PAIR_OPS) == (30 * 23, 30 * 3)
    assert kt.pair_ops(pairs, kt.K2_PAIR_OPS, kinds=(0, 1, 2)) == (
        10 * 10 + 20 * 12 + 30 * 38, 20 + 30 * 4)
    ms, by = kt.bound_ms(3.35e9, (0, 0))
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = kt.bound_ms(0, (0, kt.PEAK_SFU_PER_S / 1e3))
    assert by == "operations" and ms == pytest.approx(1.0)
    assert kt.composite_bytes(10, 4, 2, 8, 2) == 40 + 192 + 16 + 320
    assert kt.composite_bytes(10, 4, 2, 8, 2, backward=True) == (
        40 + 192 + 16 + 384 + 360)
    assert kt.segment_sums_bytes(10, 12, 4) == 360 + 48 + 20 + 16 + 144


def test_path_bounds_of_one_view():
    """Each kernel of a view's path: its (bytes, operations), the live
    slots capped at the instance cap."""
    from event3dgs_tpu_torch.ops.sort_tiles import SEGMENT, segments

    offsets = torch.tensor([0, 3, 3, 10, 12], dtype=torch.int32)
    pairs = [10, 20, 30]
    b = kt.path_bounds(4, 10, offsets, 6, pairs, 2, 8, 2)
    assert set(b) == {"K1 composite_forward", "K2 composite_backward",
                      "K3 segment_sums", "K4 gaussian_tables",
                      "K4 depth_sort", "K4 depth_offsets", "K4 depth_order",
                      "K4 depth_order, argsort's", "K4 expand_instances",
                      "K5 tile_histogram", "K6 stable_tile_rank",
                      "preprocess_forward", "preprocess_backward"}
    # SH degree 3 over 16 coefficients: 236 bytes read and 41 written a
    # Gaussian forward and its 48-byte packed row, 265 read and 232
    # written backward
    assert b["preprocess_forward"] == (4 * 325, (4 * 266, 4 * 16))
    assert b["preprocess_backward"] == (4 * 497, (4 * 532, 4 * 12))
    assert kt.path_bounds(4, 10, offsets, 6, pairs, 2, 8, 2, coeffs=25,
                          sh_degree=1)["preprocess_backward"][0] == (
        4 * (12 + 12 + 16 + 1 + 48 + 32 + 40 + 300))
    # three views in one launch: the inputs read once, each view's outputs
    # and packed row (forward) or upstream gradients and valid (backward)
    # per view; the step's tap read once, 8 bytes a Gaussian
    assert kt.preprocess_bytes(4, 16, 3, views=3) == 4 * (236 + 3 * 89)
    assert kt.preprocess_bytes(4, 16, 3, views=3, tap=True) == (
        4 * (244 + 3 * 89))
    assert kt.preprocess_bytes(4, 16, 3, backward=True, views=3) == (
        4 * (232 + 3 * 33 + 232))
    assert kt.preprocess_ops(4, 3, backward=True, views=3) == (
        3 * 4 * 532, 3 * 4 * 12)
    assert b["K4 gaussian_tables"] == (4 * 89, (240, 28))
    # the depth order: key and count read, order and offset written, a rank
    # per segment; the sort and the offsets kernel; the yardstick of an
    # order from an argsort, its int64 order read too
    assert b["K4 depth_order"] == (4 * 16 + 4 + segments(10) * 4, (0, 0))
    assert b["K4 depth_sort"] == (4 * 16, (0, 0))
    assert b["K4 depth_offsets"] == (4 * 8 + 4 + segments(10) * 4, (0, 0))
    assert b["K4 depth_order, argsort's"] == (4 * 20 + 4 + segments(10) * 4,
                                            (0, 0))
    # ranks 0 and 2 start under the cap (rank 1 is empty, rank 3 at it)
    assert b["K4 expand_instances"] == (2 * 56 + 80 + -(-10 // SEGMENT) * 8,
                                        (0, 0))
    assert b["K5 tile_histogram"] == (10 * 4 + 8, (0, 0))
    assert b["K6 stable_tile_rank"] == (10 * 4 + 8 + 40, (0, 0))
    assert b["K1 composite_forward"] == (
        kt.composite_bytes(6, 4, 2, 8, 2), kt.pair_ops(pairs, kt.K1_PAIR_OPS))
    assert b["K2 composite_backward"] == (
        kt.composite_bytes(6, 4, 2, 8, 2, backward=True),
        kt.pair_ops(pairs, kt.K2_PAIR_OPS))
    assert b["K3 segment_sums"] == (kt.segment_sums_bytes(6, 10, 4),
                                    (6 * 9, 0))


# a replay's device work in the order it ran, as replay_kernels lists it:
# (name, µs), the marker kernels where stage_markers put them
M = ss.MARKER
REPLAY = [
    ("Memcpy HtoD (Pageable -> Device)", 1.0),
    ("index_select_kernel", 2.0),
    (M, 0.5), ("preprocess_forward_kernel", 3.0), ("fill_kernel", 4.0),
    (M, 0.5),
    (M, 0.5), ("gaussian_table_kernel", 6.0),
    ("DeviceRadixSortOnesweepKernel", 7.0),
    ("DeviceRadixSortHistogramKernel", 1.0), ("depth_offsets_kernel", 2.0),
    ("expand_kernel", 3.0), ("segment_count_kernel", 1.0),
    ("scan_kernel", 1.0), ("rank_kernel", 2.0), ("fill_kernel", 0.25),
    ("composite_forward_kernel", 30.0),
    (M, 0.5),
    (M, 0.5), ("conv2d_kernel", 9.0), (M, 0.5),
    (M, 0.5), ("reduce_kernel", 2.0),
    (M, 0.5), ("composite_backward_kernel", 50.0),
    ("segment_sums_kernel", 4.0), ("ranges_kernel", 1.0),
    ("row_sums_kernel", 2.0), ("DeviceRadixSortOnesweepKernel", 0.75),
    (M, 0.5), ("preprocess_backward_kernel", 5.0),
    ("elementwise_kernel", 1.5),
    (M, 0.5), ("vectorized_elementwise_kernel", 2.5),
    (M, 0.5), ("elementwise_kernel", 3.5),
    (M, 0.5), ("multi_tensor_apply_kernel", 8.0), (M, 0.5),
    (M, 0.5), ("vectorized_elementwise_kernel", 1.25), (M, 0.5),
    ("Memcpy DtoH (Device -> Pageable)", 1.0),
]
MARKS = ["preprocess fwd", "other", "rasterizer fwd", "other", "loss fwd",
         "other", "loss bwd", "rasterizer bwd", "preprocess bwd",
         "other", "other", "Adam fwd", "other", "densify stats fwd",
         "other"]


def test_replay_split_groups_a_fixed_kernel_list():
    """The replay split on a fixed list of kernel names: the port's own
    kernels by name wherever they run, the sort kernels as the binning's
    argsort only inside the rasterizer's forward, the rest by the stage
    the last marker names, ``other`` before the first, the copies there
    apart; markers left out."""
    labelled = ss.stage_labels(REPLAY, MARKS)
    assert len(labelled) == len(REPLAY) - len(MARKS)
    assert labelled[0] == ("Memcpy HtoD (Pageable -> Device)", 1.0, "other")
    totals = ss.split_totals(labelled)
    assert list(totals) == list(ss.SPLIT_ORDER)
    want = {"K1": [30.0, 1], "K2": [50.0, 1], "K3": [4.0 + 1.0 + 2.0, 3],
            "binning kernels": [15.0, 6], "argsort": [8.0, 2],
            "preprocess forward": [3.0, 1], "preprocess backward": [5.0, 1],
            "preprocess, other": [4.0 + 1.5, 2],
            "rasterizer, other": [0.25 + 0.75, 2], "loss": [9.0 + 2.0, 2],
            "Adam": [8.0, 1], "densify stats": [1.25, 1],
            "other, copies": [1.0 + 1.0, 2], "other": [2.0 + 2.5 + 3.5, 3]}
    assert totals == want
    assert sum(k for _, k in totals.values()) == len(labelled)
    assert ss.split_group("composite_forward_kernel", "loss bwd") == "K1"
    assert ss.split_group("preprocess_backward_kernel", "other") == \
        "preprocess backward"
    assert ss.split_group("DeviceRadixSortOnesweepKernel", "loss fwd") == "loss"
    assert ss.split_group("spin", "nowhere") == "other"
    assert ss.split_group("adam_update_kernel", "other") == "Adam"
    assert ss.split_group("Memcpy DtoD (Device -> Device)", "other") == \
        "other, copies"
    assert ss.split_group("Memcpy DtoD (Device -> Device)", "loss fwd") == \
        "loss"
    with pytest.raises(ValueError, match="marker kernels"):
        ss.stage_labels(REPLAY, MARKS[:-1])


def test_replay_split_by_function():
    """The split by CUDA function: the profiler's keys labelled by kernel
    name and, for PyTorch's templated kernels, the functor or kernel
    function they run; each group's functions with device µs and
    launches, largest first."""
    arr = "at::detail::Array<char*, 3>"
    add = (f"void at::native::vectorized_elementwise_kernel<4, "
           f"at::native::CUDAFunctor_add<float>, {arr} >(int, "
           f"at::native::CUDAFunctor_add<float>, {arr})")
    mul = ("void at::native::elementwise_kernel<128, 2, "
           "at::native::gpu_kernel_impl_nocast<at::native::BinaryFunctor<"
           "float, float, float, at::native::binary_internal::MulFunctor<"
           "float> > >(at::TensorIteratorBase&)::{lambda(int)#1}>(int)")
    exp = ("void at::native::vectorized_elementwise_kernel<4, at::native::"
           "(anonymous namespace)::exp_kernel_cuda(at::TensorIteratorBase&)::"
           "{lambda()#2}::operator()() const::{lambda(float)#1}, "
           "at::detail::Array<char*, 2> >(int)")
    ours = ("void (anonymous namespace)::preprocess_backward_kernel<3>("
            "(anonymous namespace)::Args)")
    assert ss.function_label(add) == \
        "vectorized_elementwise_kernel<CUDAFunctor_add>"
    assert ss.function_label(mul) == "elementwise_kernel<MulFunctor>"
    assert ss.function_label(exp) == \
        "vectorized_elementwise_kernel<exp_kernel_cuda>"
    assert ss.function_label(ours) == "preprocess_backward_kernel"
    assert ss.function_label("Memcpy DtoD (Device -> Device)") == \
        "Memcpy DtoD (Device -> Device)"
    keys = [add, exp, add, ours, mul, add]
    labelled = [(kt.kernel_name(k), us, stage) for k, us, stage in zip(
        keys, (2.0, 3.0, 1.0, 5.0, 0.5, 4.0),
        ("other", "other", "rasterizer fwd", "preprocess bwd", "other",
         "other"))]
    got = ss.split_functions(labelled, keys)
    assert got == {
        "other": {"vectorized_elementwise_kernel<CUDAFunctor_add>": [6.0, 2],
                  "vectorized_elementwise_kernel<exp_kernel_cuda>": [3.0, 1],
                  "elementwise_kernel<MulFunctor>": [0.5, 1]},
        "rasterizer, other": {
            "vectorized_elementwise_kernel<CUDAFunctor_add>": [1.0, 1]},
        "preprocess backward": {"preprocess_backward_kernel": [5.0, 1]}}
    assert list(got["other"])[0].endswith("CUDAFunctor_add>")
    assert "other" in ss.BY_FUNCTION and "rasterizer, other" in ss.BY_FUNCTION


def test_stage_markers_mark_each_stage_of_an_eager_step(monkeypatch):
    """On the CPU, with the marker kernel replaced by a record of its
    labels: one eager step of ``GraphTrainStep`` under ``stage_markers``
    marks the start of each stage forward and backward, and leaving the
    block restores the step's functions."""
    import importlib

    from event3dgs_tpu_torch.train import step as step_mod
    from event3dgs_tpu_torch.train.fused import FusedSteps
    from event3dgs_tpu_torch.utils.config import EventConfig, OptimizationConfig

    render = importlib.import_module("event3dgs_tpu_torch.ops.render")
    seen = []
    monkeypatch.setattr(ss, "_marker", seen.append)
    state, data, icap = kt.bench_state("cpu", 300, 64, 48)
    step = step_mod.GraphTrainStep("event", OptimizationConfig(),
                                   EventConfig(), spatial_lr_scale=3.0,
                                   rasterizer="tiled", instance_cap=icap)
    staged = [(render, "preprocess"), (render, "rasterize_tiled_partials"),
              (step_mod, "preprocess_views")]
    before = [getattr(m, n) for m, n in staged]
    runner = FusedSteps(step, state, data, 1)
    row = torch.from_numpy(step.row(1, (1, 1, 2), np.zeros(3))[None])
    with ss.stage_markers([]):
        loss = runner.run(row)[0]
    assert np.isfinite(loss)
    assert [getattr(m, n) for m, n in staged] == before
    starts = [m for m in seen if m != "other"]
    # one preprocess call for the three views, three renders' rasterizers
    assert starts.count("preprocess fwd") == starts.count("preprocess bwd") == 1
    assert starts.count("rasterizer fwd") == 3
    assert starts.count("rasterizer bwd") == 3
    assert starts.count("loss fwd") == starts.count("loss bwd") == 1
    assert starts.count("Adam fwd") == 1  # the Gaussians and contrast
    assert starts.count("densify stats fwd") == 1
    fwd = starts.index("loss fwd")
    assert all(m.endswith("fwd") for m in starts[:fwd])
    assert starts[fwd + 1] == "loss bwd"
    assert starts[-2:] == ["Adam fwd", "densify stats fwd"]


# an excerpt of a CUDA graph DOT dump of a captured binning
# (cuGraphDebugDotPrint, verbose; NVIDIA H100 80GB HBM3, CUDA 12.8): a
# kernel of ours in an anonymous namespace, a copy, one of PyTorch's
# kernels, a memset, a CUB template kernel, and the edges
DOT = r"""digraph dot {
subgraph cluster_1 {
label="graph_1" graph[style="dashed"];
"graph_1_node_0"[style="bold" shape="record" label="{KERNEL
| {ID | 0 (topoId: 4) | _ZN41_GLOBAL__N__ab4e71e4_9_expand_cu_488286f321gaussian_table_kernelEPKfS1_S1_PKbS1_S1_iiifP4int4P6float4PfPyi\<\<\<391,256,0\>\>\>}
| {{node handle | func handle} | {0x0000000013DD0DC0 | 0x0000000012D30EE0}}
| {cooperative | 0}
}"];

"graph_1_node_1"[style="solid" shape="record" label="{
MEMCPY
| {{ID | node handle} | {1 (topoId: 3) | 0x0000000013DD1528}}
| {Extent | {WidthInBytes | Height | Depth} | {400000 | 1 | 1}}
}"];

"graph_1_node_2"[style="bold" shape="record" label="{KERNEL
| {ID | 2 (topoId: 2) | _ZN2at6native46_GLOBAL__N__e17e1519_13_SortStable_cu_f7bb90a127fill_reverse_indices_kernelEPliNS_4cuda6detail10IntDividerIjEE\<\<\<98,1024,0\>\>\>}
}"];

"graph_1_node_3"[style="solid" style="solid" shape="record" label="{MEMSET
| {{ID | node handle | dptr | pitch | value | elementSize | width | height} | {3 (topoId: 1) | 0x0000000013DD23F8 | 0x00007F35AE1BFA00 | 0 | 0 | 1 | 16 | 1}}}"];

"graph_1_node_4"[style="bold" shape="record" label="{KERNEL
| {ID | 4 (topoId: 0) | _ZN14at_cuda_detail3cub30DeviceRadixSortHistogramKernelINS0_21DeviceRadixSortPolicyIfN2at4cuda3cub6detail10OpaqueTypeILi8EEEyE9Policy900ELb0EfyNS0_6detail21identity_decomposer_tEEEvPT2_PKT1_SD_iiT3_\<\<\<2112,128,0\>\>\>}
}"];

"graph_1_node_5"[style="bold" shape="record" label="{KERNEL
| {ID | 5 (topoId: 0) | _ZN46_GLOBAL__N__8710cfb3_13_sort_tiles_cu_c76d93de11rank_kernelEPKiS1_iS1_iiS1_S1_S1_PiiiS2_S2_S2_\<\<\<209,256,8160\>\>\>}
}"];

"graph_1_node_0" -> "graph_1_node_1" [headlabel=0];
"graph_1_node_1" -> "graph_1_node_2" [headlabel=0];
"graph_1_node_2" -> "graph_1_node_3" [headlabel=0];
"graph_1_node_3" -> "graph_1_node_4" [headlabel=0];
"graph_1_node_4" -> "graph_1_node_5" [headlabel=0];
}
}
"""


def test_dot_nodes_of_a_cuda_graph_dump():
    """Each node of a CUDA graph's DOT dump, in order, with its kind and
    its kernel's function; the edges are no nodes."""
    assert kt.dot_nodes(DOT) == [
        ("kernel", "gaussian_table_kernel"), ("memcpy", ""),
        ("kernel", "fill_reverse_indices_kernel"), ("memset", ""),
        ("kernel", "DeviceRadixSortHistogramKernel"),
        ("kernel", "rank_kernel")]
    assert kt.dot_nodes("digraph dot {\n}\n") == []


@pytest.mark.parametrize("text, name", [
    ("_Z20segment_count_kernelPKiS0_iPi", "segment_count_kernel"),
    ("| {ID | 0 | _ZN2at6native29vectorized_elementwise_kernelILi4ENS0_11"
     "FillFunctorIfEEEEviT0_T1_\\<\\<\\<2,128,0\\>\\>\\>}",
     "vectorized_elementwise_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<float> >(int, at::native::FillFunctor<float>)",
     "vectorized_elementwise_kernel"),
    ("segment_sums_kernel(float const*, int)", "segment_sums_kernel"),
    ("| scan_kernel\\<\\<\\<1,256\\>\\>\\>}", "scan_kernel"),
])
def test_dot_kernel_name(text, name):
    """A kernel node's function, from a mangled name (plain or nested) or
    a demangled signature or launch."""
    assert kt.dot_kernel_name(text) == name


def test_graph_kernels_counts_the_nodes(monkeypatch):
    """{function: nodes} of a call's graph, memsets and copies by kind; a
    dump without a node is refused."""
    calls = []
    monkeypatch.setattr(kt, "graph_dot", lambda fn: calls.append(fn) or DOT)
    assert kt.graph_kernels(print) == {
        "gaussian_table_kernel": 1, "memcpy": 1,
        "fill_reverse_indices_kernel": 1, "memset": 1,
        "DeviceRadixSortHistogramKernel": 1, "rank_kernel": 1}
    assert calls == [print]
    monkeypatch.setattr(kt, "graph_dot", lambda fn: "digraph dot {\n}\n")
    with pytest.raises(RuntimeError, match="no node"):
        kt.graph_kernels(print)


def test_bench_scene_is_bench_pys():
    rng = np.random.default_rng(0)
    means = np.c_[rng.uniform(-3, 3, 50), rng.uniform(-1.8, 1.8, 50),
                  rng.uniform(2, 10, 50)]
    got = kt.bench_scene(np.random.default_rng(0), 50)
    np.testing.assert_array_equal(got[0], means)
    assert [a.shape for a in got] == [(50, 3), (50, 3), (50, 4), (50,), (50, 3)]


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__a723133d_16_rasterize_fwd_cu_97c0e57924composite_forward_kernelEPKiS1_S1_PKfiiiPfS4_Pi' for 'sm_90a'
ptxas info    : Function properties for _ZN49_GLOBAL__N__a723133d_16_rasterize_fwd_cu_97c0e57924composite_forward_kernelEPKiS1_S1_PKfiiiPfS4_Pi
    32 bytes stack frame, 32 bytes spill stores, 28 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 32 bytes cumulative stack size, 24832 bytes smem
ptxas info    : Compile time = 87.548 ms
ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__50ca3292_9_expand_cu_488286f313expand_kernelEPK4int4PK6float4PKiS7_S7_iiiiPiS8_S8_' for 'sm_90a'
ptxas info    : Function properties for _ZN41_GLOBAL__N__50ca3292_9_expand_cu_488286f313expand_kernelEPK4int4PK6float4PKiS7_S7_iiiiPiS8_S8_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 54 registers, used 1 barriers, 112 bytes smem
"""


def test_ptxas_report():
    assert kt.ptxas_report(PTXAS_LOG, "composite_forward_kernel") == {
        "registers": 64, "spill_stores": 32, "spill_loads": 28, "smem": 24832}
    assert kt.ptxas_report(PTXAS_LOG, "expand_kernel") == {
        "registers": 54, "spill_stores": 0, "spill_loads": 0, "smem": 112}
    with pytest.raises(ValueError):
        kt.ptxas_report(PTXAS_LOG, "depth_offsets_kernel")


# two instances of a kernel template, as the SSIM kernels' build reports
# them (rgb's <3>, gray's <1>)
PTXAS_TEMPLATE_LOG = """\
ptxas info    : Compiling entry function '_ZN39_GLOBAL__N__1c371d4d_7_ssim_cu_8c0bf7c431photometric_loss_forward_kernelILi1EEEvNS_8OperandsENS_6ConstsEPdPfS4_S4_' for 'sm_90a'
ptxas info    : Function properties for _ZN39_GLOBAL__N__1c371d4d_7_ssim_cu_8c0bf7c431photometric_loss_forward_kernelILi1EEEvNS_8OperandsENS_6ConstsEPdPfS4_S4_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 80 bytes smem
ptxas info    : Compiling entry function '_ZN39_GLOBAL__N__1c371d4d_7_ssim_cu_8c0bf7c431photometric_loss_forward_kernelILi3EEEvNS_8OperandsENS_6ConstsEPdPfS4_S4_' for 'sm_90a'
ptxas info    : Function properties for _ZN39_GLOBAL__N__1c371d4d_7_ssim_cu_8c0bf7c431photometric_loss_forward_kernelILi3EEEvNS_8OperandsENS_6ConstsEPdPfS4_S4_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 120 registers, used 1 barriers, 80 bytes smem
"""


@pytest.mark.parametrize("gray,registers", [(False, 120), (True, 80)])
def test_ptxas_report_of_a_template_instance(gray, registers):
    got = kt.ptxas_report(PTXAS_TEMPLATE_LOG,
                          "photometric_loss_forward_kernel",
                          kp.ssim_template(gray))
    assert got == {"registers": registers, "spill_stores": 0,
                   "spill_loads": 0, "smem": 80}
    with pytest.raises(ValueError):  # not the name of a plain function
        kt.ptxas_report(PTXAS_TEMPLATE_LOG, "photometric_loss_forward_kernel")


def test_clock_imbalance_of_hand_made_blocks(monkeypatch):
    class Props:
        multi_processor_count = 1

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: Props)
    # a wave of 2: blocks [0, 10) and [0, 10), then [10, 40) alone
    clock = torch.tensor([[0, 10], [0, 10], [10, 40]], dtype=torch.int64)
    got = kp.clock_imbalance(clock, blocks_per_sm=2)
    assert got["blocks"] == 3 and got["full_wave"] == 2
    assert got["span_us"] == 0.04 and got["median_block_us"] == 0.01
    assert got["longest_over_median"] == 3.0
    assert got["under_full_wave_share"] == 0.75
    assert got["mean_running_share"] == (2 * 10 + 30) / (40 * 2)
    assert got["tail_share"] == 0.75


def test_k3_sweep_segments_have_the_2m_views_shape():
    """The K3 sweep's seeded inputs: contiguous ranges, the last 13.5 %
    empty, twice as many slots as segments, each instance's slot distinct
    and the slots past the instances the drop value, ``order`` a
    permutation; and K3's plain version sums them."""
    rows, starts, ends, slots, dest, order = kt.sweep_segments(
        2000, torch.device("cpu"))
    assert torch.equal(starts[1:], ends[:-1]) and int(starts[0]) == 0
    assert not (ends - starts)[1730:].any() and (ends - starts)[:1730].any()
    total = int(ends[-1])
    assert slots == 4000 == rows.shape[0] == dest.shape[0]
    assert len(set(dest[:total].tolist())) == total
    assert int(dest[:total].max()) < slots and (dest[total:] == slots).all()
    assert torch.equal(torch.sort(order).values,
                       torch.arange(2000, dtype=torch.int32))
    out = segscan.segment_sums(rows, starts, ends, slots, dest, order)
    assert out.shape == (2000, 9) and not out[order[1730:].long()].any()
