"""Whole runs of the harness on the CPU at the tiny size (the look for a
card skipped), a run without a card, and a new configuration, cell and
per-layer metric found as new files."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import run
from benchmark.tests.tiny import ROOT, tiny_root

CPU = torch.device("cpu")
SEED = 2**31 + 77


def tiny_run(root, cell: str, trace: int = 0, seed: int = SEED) -> dict:
    args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
                      "--trace", str(trace)])
    return run.run(args, root=root, device=CPU)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", ["event_gray_2m.train", "rgb_3m.train"])
def test_tiny_run_is_correct(root, cell):
    out = tiny_run(root, cell)
    assert out["correct"] is True and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    bench = run.manifest(root)
    want = {m["name"] for m in bench["end_to_end"] if run.applies(m, cell)}
    assert set(out["metrics"]) == want
    # no card: no memory peak to read, every other number is positive
    assert all(v["value"] > 0 for k, v in out["metrics"].items()
               if k != "train_peak_gib")


def test_traced_run_reports_layer_metrics_it_can_read(root):
    out = tiny_run(root, "rgb_3m.train", trace=1)
    # on the CPU there is no device trace and no graph capture: only what
    # needs neither is read
    assert set(out["metrics"]) == {"step_mfu.train"}
    assert 0 < out["metrics"]["step_mfu.train"]["value"] < 100
    assert out["device"]["busy_s"] == 0.0 and out["device"]["window_s"] > 0


def test_work_is_counted_over_the_window_at_its_close(root, monkeypatch):
    """The traced run counts each of the window's steps at its own views
    and at the parameters where the window closed: the whole step's share
    is the mean of the steps' operations over the window's time a step."""
    from benchmark.counts import bounds, work
    from benchmark.traffic import train

    steps = []
    counted = work.train_step

    def each(*a):
        steps.append(counted(*a))
        return steps[-1]

    monkeypatch.setattr(work, "train_step", each)
    made = {}
    work_of = train.Driver.work

    def spy(self):
        made["closing"], made["initial"] = self.closing, self._initial()[0]
        return work_of(self)

    monkeypatch.setattr(train.Driver, "work", spy)
    out = tiny_run(root, "event_gray_2m.train", trace=1)
    closing, initial = made["closing"], made["initial"]
    assert set(closing) == set(train.ref.LEAVES)
    assert not torch.equal(closing["xyz"], initial["xyz"])  # the window moved them
    assert len(steps) == out["attempted"] > 1
    assert len({s["k1_ms"] for s in steps}) > 1  # the steps' views differ
    mean = sum(s["fp32_ops"] for s in steps) / len(steps)
    per_step = out["device"]["window_s"] / out["attempted"]
    want = 100.0 * mean / (per_step * bounds.PEAK_FP32_PER_S)
    assert out["metrics"]["step_mfu.train"]["value"] == pytest.approx(want, rel=1e-12)


def test_no_card_no_result(tmp_path):
    for cwd in (ROOT, tmp_path):
        if cwd == tmp_path:  # a checkout of the benchmark's files alone
            shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
            shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                            ignore=shutil.ignore_patterns("__pycache__"))
        p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                            "event_gray_2m.train", "--seed", "1", "--seconds", "1",
                            "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                           env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
        assert p.returncode != 0 and p.stdout == ""


def test_new_files_are_found_without_an_edit(root, tmp_path):
    new = tiny_root(tmp_path)
    bench = json.loads((new / "BENCHMARK.json").read_text())
    cfg = json.loads((new / "benchmark/configs/event_gray_2m.json").read_text())
    cfg["name"] = "event_gray_tiny"
    (new / "benchmark/configs/event_gray_tiny.json").write_text(json.dumps(cfg))
    wl = json.loads((new / "benchmark/workloads/event_gray_2m.train.json").read_text())
    wl["config"] = "event_gray_tiny"
    (new / "benchmark/workloads/event_gray_tiny.train.json").write_text(json.dumps(wl))
    (new / "benchmark/layer_metrics/probe_constant.py").write_text(
        "def read(ctx):\n    return 42.0 + ctx.work['units'] * 0\n")
    bench["configs"].append({"name": "event_gray_tiny", "source": cfg["source"],
                             "file": "benchmark/configs/event_gray_tiny.json",
                             "reduced": [], "why": "a test's"})
    bench["workloads"].append({"name": "event_gray_tiny.train", "config": "event_gray_tiny",
                               "traffic": "train", "chips": 1, "why": "a test's"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "event_gray_2m.train" in m["workloads"]:
            m["workloads"].append("event_gray_tiny.train")
    bench["per_layer"].append({"name": "probe_constant.train", "unit": "%",
                               "better": "higher", "source": "program_counter",
                               "layer": "device", "moves": "train_it_s",
                               "workloads": ["event_gray_tiny.train"]})
    (new / "BENCHMARK.json").write_text(json.dumps(bench))
    out = tiny_run(new, "event_gray_tiny.train", trace=1)
    assert out["correct"] is True
    assert out["metrics"]["probe_constant.train"]["value"] == 42.0


def test_a_reader_serves_its_own_name_before_its_base_name(tmp_path):
    folder = tmp_path / "benchmark" / "layer_metrics"
    folder.mkdir(parents=True)
    (folder / "probe.py").write_text("def read(ctx):\n    return 1.0\n")
    (folder / "probe.serve.py").write_text("def read(ctx):\n    return 2.0\n")
    assert run.load_reader("probe.train", tmp_path)(None) == 1.0
    assert run.load_reader("probe.serve", tmp_path)(None) == 2.0
    assert run.reader_path("device_idle.train") == \
        ROOT / "benchmark" / "layer_metrics" / "device_idle.py"
