"""``correct`` comes out false where it should: for the control (the
reference in bfloat16 put in the program's place) and for runs of the
harness, the look for a card skipped, with the timed path broken
underneath: a step that leaves the state unchanged, a loss over half the
pixels (the mean over the rest).  One chip holds these cells, so no
exchange between chips can be left out, and a training cell produces no
answer to alter but its state, which the other two faults break.
"""

from __future__ import annotations

import pytest
import torch

from benchmark import run
from benchmark.tests.test_bench_runs import tiny_run
from benchmark.tests.tiny import tiny_root
from benchmark.traffic import train

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def driver(root, cell, seed):
    _, wl, cfg = run.cell(run.manifest(root), cell, root)
    return train.Driver(run.Harness(cfg, wl, seed, CPU, run.Tracer(False)))


@pytest.mark.parametrize("cell", ["event_gray_2m.train", "rgb_3m.train"])
@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_control_is_not_correct(root, cell, seed):
    checks = driver(root, cell, seed).control(torch.bfloat16)
    assert not all(c.ok for c in checks)


def _left_half(x):
    from event3dgs_tpu_torch.losses.event import Frame, Partials

    if isinstance(x, Partials):
        w = x.rgb.shape[1] // 2
        return Partials(x.rgb[:, :w].contiguous(), x.logt[:, :w].contiguous())
    if isinstance(x, Frame):
        w = x.stack.shape[2] // 2
        return Frame(x.stack[:, :, :w].contiguous(), x.index)
    return x


@pytest.mark.parametrize("cell", ["event_gray_2m.train", "rgb_3m.train"])
def test_a_step_that_leaves_the_state_unchanged_fails(root, cell, monkeypatch):
    import event3dgs_tpu_torch.train.step as step

    monkeypatch.setattr(step, "adam_update_groups",
                        lambda groups, out=None: [(g.params, g.state) for g in groups])
    out = tiny_run(root, cell)
    assert out["correct"] is False
    assert out["checks"]["change_gap"]["value"] > out["checks"]["change_gap"]["limit"]


@pytest.mark.parametrize("cell,loss", [("event_gray_2m.train", "event_total_loss"),
                                       ("rgb_3m.train", "rgb_total_loss")])
def test_a_loss_over_half_the_pixels_fails(root, cell, loss, monkeypatch):
    import event3dgs_tpu_torch.train.step as step

    whole = getattr(step, loss)
    monkeypatch.setattr(step, loss, lambda *a, **k: whole(*map(_left_half, a), **k))
    assert tiny_run(root, cell)["correct"] is False

