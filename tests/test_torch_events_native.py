"""The port's native DVS simulator (its own copy of ``dvs_native.cpp``,
built with g++ into the port's git-ignored build directory and bound with
ctypes) against the JAX package's CPython module and the numpy model, on
the CPU."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from event3dgs_tpu.events.dvs_model import DvsParams as JParams
from event3dgs_tpu.events.native import NativeDvsSimulator as JNative
from event3dgs_tpu_torch.events import native
from event3dgs_tpu_torch.events.dvs_model import (
    DvsParams,
    DvsSimulator,
    default_noise_hists,
)
from event3dgs_tpu_torch.events.native import NativeDvsSimulator

ROOT = pathlib.Path(__file__).resolve().parents[1]
W, H = 40, 30


def frames(seed, n=5):
    rng = np.random.default_rng(seed)
    out = [rng.uniform(40, 220, (H, W))]
    for _ in range(n - 1):
        out.append(out[-1] * rng.uniform(0.7, 1.4, (H, W)))
    return out


def run(sim, noise, seq, dts=(1500, 800, 20_000, 1500)):
    if noise:
        sim.init_noise(*default_noise_hists(noise))
    else:
        sim.disable_noise()
    sim.init_image(seq[0])
    return [(sim.update(f, dt).to_structured(), sim.voltages.copy())
            for f, dt in zip(seq[1:], dts)]


MODES = {
    "deterministic": (dict(th_noise=0.0, jitter=0.0), None),
    "noise": ({}, None),
    "background_bright": ({}, "bright"),
    "background_low_light": (dict(th_pos=0.2, th_neg=0.25), "low_light"),
}


@pytest.mark.parametrize("seed", [12345, 7])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_native_streams_equal_the_jax_native_module(mode, seed):
    kw, noise = MODES[mode]
    seq = frames(seed)
    want = run(JNative(W, H, JParams(**kw), seed=seed), noise, seq)
    got = run(NativeDvsSimulator(W, H, DvsParams(**kw), seed=seed), noise, seq)
    assert sum(len(ev) for ev, _ in want) > 100
    for (ev_j, v_j), (ev_t, v_t) in zip(want, got):
        assert ev_t.dtype == ev_j.dtype
        np.testing.assert_array_equal(ev_t, ev_j)
        np.testing.assert_array_equal(v_t, v_j)


def test_native_equals_the_numpy_model_when_deterministic():
    p = DvsParams(th_noise=0, jitter=0)
    seq = frames(3)
    nat, py = NativeDvsSimulator(W, H, p), DvsSimulator(W, H, p)
    for sim in (nat, py):
        sim.disable_noise()
        sim.init_image(seq[0])
    key = ["t", "x", "y", "p"]
    for f in seq[1:]:
        a, b = nat.update(f, 1500).to_structured(), py.update(f, 1500).to_structured()
        assert len(a) == len(b) > 0
        np.testing.assert_array_equal(np.sort(a, order=key), np.sort(b, order=key))
    np.testing.assert_allclose(nat.voltages, py.cur_v.reshape(H, W), rtol=1e-12)


def test_simulators_are_independent():
    """Each simulator has its own state (the JAX module keeps one global):
    two interleaved give the streams each gives alone."""
    seq_a, seq_b = frames(1), frames(2)
    alone = [run(NativeDvsSimulator(W, H, seed=s), "bright", seq)
             for s, seq in ((1, seq_a), (2, seq_b))]
    a, b = NativeDvsSimulator(W, H, seed=1), NativeDvsSimulator(W, H, seed=2)
    for sim, seq in ((a, seq_a), (b, seq_b)):
        sim.init_noise(*default_noise_hists("bright"))
        sim.init_image(seq[0])
    for i in range(1, len(seq_a)):
        for sim, seq, ref in ((a, seq_a, alone[0]), (b, seq_b, alone[1])):
            dt = (1500, 800, 20_000, 1500)[i - 1]
            np.testing.assert_array_equal(sim.update(seq[i], dt).to_structured(),
                                          ref[i - 1][0])


def test_wrapper_checks_sizes():
    sim = NativeDvsSimulator(W, H)
    with pytest.raises(ValueError, match=f"expected {W * H} values"):
        sim.init_image(np.ones((H, W + 1)))
    with pytest.raises(ValueError):
        sim.init_noise(np.ones((4, 72)), np.ones((3, 72)))
    with pytest.raises(RuntimeError, match="dvs_init_noise"):
        sim.init_noise(np.ones((0, 72)), np.ones((0, 72)))


def test_the_core_is_the_jax_source_and_the_build_stays_in_the_port():
    """The simulator core is the JAX package's text; only the binding
    differs (no Python headers).  The library lives in the port's
    git-ignored build directory, keyed by the source and the flags."""
    def core(text):
        return text[text.index("namespace {"):text.index("\n};\n", text.index("struct Simu {"))]

    jax_src = (ROOT / "event3dgs_tpu" / "events" / "native" / "dvs_native.cpp").read_text()
    port_src = native.SRC.read_text()
    assert core(port_src) == core(jax_src)
    assert "Python.h" not in port_src
    for fn in native.SIGNATURES:
        assert re.search(rf"\b{fn}\(", port_src), fn
    path = native.build()
    assert path.parent == ROOT / "event3dgs_tpu_torch" / "events" / "native" / "build"
    assert path == native.library_path() and path.name.startswith("libdvs_native_")
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "event3dgs_tpu_torch/events/native/build/" in ignored


def test_concurrent_builds_leave_one_library(tmp_path):
    """Builds write a temporary file and rename it into place, so processes
    building at once (pytest-xdist workers) all succeed."""
    code = ("import pathlib, sys; from event3dgs_tpu_torch.events import native; "
            "native.BUILD_DIR = pathlib.Path(sys.argv[1]); "
            "p = native.build(); native.load(); print(p)")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=300)[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert len(set(outs)) == 1
    assert sorted(f.name for f in tmp_path.iterdir()) == [pathlib.Path(outs[0]).name]


def test_import_builds_nothing():
    code = ("import event3dgs_tpu_torch.events, event3dgs_tpu_torch.cli.render, "
            "event3dgs_tpu_torch.cli.generate_dataset; "
            "from event3dgs_tpu_torch.events import native; "
            "assert native._lib is None")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)
