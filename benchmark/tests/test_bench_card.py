"""The harness on a card at the tiny size, through the port's kernels:
each cell's run is correct and reads every per-layer metric.  Skips
without a CUDA card (decided inside the test)."""

from __future__ import annotations

import pytest
import torch

from benchmark import run
from benchmark.tests.tiny import tiny_root


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["event_gray_2m.train", "rgb_3m.train"])
def test_tiny_cells_on_the_card(cell, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    root = tiny_root(tmp_path)
    args = run.parse(["--workload", cell, "--seed", "12345", "--seconds", "1",
                      "--trace", "1"])
    out = run.run(args, root=root, device=torch.device("cuda", 0))
    assert out["correct"] is True
    bench = run.manifest(root)
    reported = [m["name"] for m in bench["end_to_end"] if run.applies(m, cell)]
    want = {m["name"] for m in bench["per_layer"] if run.applies(m, cell, reported)}
    assert set(out["metrics"]) <= want and out["device"]["busy_s"] > 0
