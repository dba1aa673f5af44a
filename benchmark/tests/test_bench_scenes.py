"""The scene and target generators give the same slots, poses, moments
and targets for the same seed in two processes, and other ones for
another seed."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.tests.tiny import ROOT, TINY

DIGEST = r"""
import json, sys, zlib, torch
from benchmark.scenes import recipes, targets
cfg = json.loads(sys.argv[1]); seed = int(sys.argv[2]); dev = torch.device("cpu")
parts = list(recipes.cloud(cfg, seed, dev).values())
v = recipes.views(cfg, dev)
parts += [v.world_view, v.full_proj, v.center, targets.render_targets(cfg, seed, dev)]
parts += [m for pair in recipes.adam_moments(cfg, seed, {"xyz": (5, 3)}, dev).values() for m in pair]
d = 0
for t in parts:
    d = zlib.crc32(t.contiguous().numpy().tobytes(), d)
print(d)
"""


def digest(cfg: dict, seed: int) -> int:
    out = subprocess.run([sys.executable, "-c", DIGEST, json.dumps(cfg), str(seed)],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return int(out.stdout.strip())


@pytest.mark.parametrize("name", sorted(TINY))
def test_same_seed_same_scene_in_two_processes(name):
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    cfg.update(slots=500, width=40, height=24)
    cfg["trajectory"]["views"] = 10
    seed = 2**31 + 12345  # a seed may pass 32 signed bits
    assert digest(cfg, seed) == digest(cfg, seed)
    assert digest(cfg, seed) != digest(cfg, seed + 1)
