"""The port's kernel probes (``tools/kernel_probes.py``) on the CPU: the
catalogue of K1 and K4 builds and how `ops/kernels.py` names and
compiles them, K1's stop statistics against a loop over pixels, the event
step's cumulative stages against the port's own functions, the plain
dynamic-grid sum, the bound arithmetic of ``tools/kernel_timing.py`` and
the command line.  Imports no JAX."""

import hashlib
import json
import re

import numpy as np
import pytest
import torch

from event3dgs_tpu_torch.ops import binning, kernels
from event3dgs_tpu_torch.ops import rasterize_tiled as rt
from event3dgs_tpu_torch.tools import kernel_probes as kp
from event3dgs_tpu_torch.tools import kernel_timing as kt
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
    colors = gaussian_colors(3, inp.features, act.means3d, cam.camera_center)
    assert torch.equal(out[1][2], colors)
    b = binning.bin_gaussians(proj.mean2d.detach(), proj.depth, proj.radius,
                              proj.valid, 96, 64, cap, opacities=act.opacities,
                              conic=proj.conic)
    for field in ("inst_gauss", "tile_offsets", "tile_counts", "dest", "offsets"):
        assert torch.equal(getattr(out[2][3], field), getattr(b, field))
    partials = render_partials(act.means3d, inp.features, act.opacities,
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
