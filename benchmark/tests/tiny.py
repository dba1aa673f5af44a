"""A checkout of the benchmark's data at a size the CPU runs in seconds, for
the harness's own tests: the cells' files with the scene cut to a few
thousand splats at 64×48, the window's logging every 2 iterations."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY = {
    "event_gray_2m": {"slots": 3000, "width": 64, "height": 48, "views": 12},
    "rgb_3m": {"slots": 3000, "width": 64, "height": 43, "views": 12},
}


def tiny_root(tmp: Path) -> Path:
    """``tmp`` made into a checkout of BENCHMARK.json and the benchmark's
    data files, cut to the tiny sizes; returns it."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for sub in ("configs", "workloads", "layer_metrics"):
        shutil.copytree(ROOT / "benchmark" / sub, tmp / "benchmark" / sub)
    for name, cut in TINY.items():
        path = tmp / "benchmark" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg.update(slots=cut["slots"], width=cut["width"], height=cut["height"])
        cfg["trajectory"]["views"] = cut["views"]
        path.write_text(json.dumps(cfg))
    for path in (tmp / "benchmark" / "workloads").glob("*.json"):
        wl = json.loads(path.read_text())
        if wl["traffic"] == "train":
            wl.update(log_every=2, warmup=2, fused_steps=2)
        path.write_text(json.dumps(wl))
    return tmp
