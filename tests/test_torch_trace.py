"""The port's span recorder (``event3dgs_tpu_torch/utils/trace.py``) on the
CPU: nesting and parent ids, the bound on kept spans, the sync counter,
spans closed by an exception, and stamps on the clock of
``torch.profiler``'s events."""

import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from event3dgs_tpu_torch.utils import trace


@pytest.fixture
def recorder():
    """The recorder empty; empty again afterwards."""
    trace.clear()
    yield trace
    trace.clear()


def by_name(records):
    return {r[2]: r for r in records}


def test_spans_nest_and_name_their_parents(recorder):
    first = trace.begun()
    with trace.span("outer", n=3):
        with trace.span("middle"):
            with trace.span("inner"):
                pass
        with trace.span("sibling") as s:
            s.n = 7
    with trace.span("next"):
        pass
    recs = trace.spans()
    assert [r[2] for r in recs] == ["inner", "middle", "sibling", "outer", "next"]
    got = by_name(recs)
    assert got["outer"][0] == first and got["outer"][1] == -1
    assert got["middle"][1] == got["sibling"][1] == got["outer"][0]
    assert got["inner"][1] == got["middle"][0]
    assert got["next"][1] == -1 and got["next"][0] == first + 4
    assert got["outer"][5] == 3 and got["sibling"][5] == 7 and got["middle"][5] == -1
    for r in recs:
        assert r[3] <= r[4]
        assert all(isinstance(v, (int, str)) for v in r)
    o, m, i = got["outer"], got["middle"], got["inner"]
    assert o[3] <= m[3] <= i[3] <= i[4] <= m[4] <= o[4]
    assert trace.begun() == first + 5 and trace.dropped() == 0


def test_the_oldest_spans_are_dropped_past_the_limit_and_counted(recorder, monkeypatch):
    monkeypatch.setattr(trace, "LIMIT", 4)
    monkeypatch.setattr(trace, "_kept", trace.collections.deque(maxlen=4))
    first = trace.begun()
    for k in range(10):
        with trace.span(f"s{k}"):
            pass
    assert [r[2] for r in trace.spans()] == ["s6", "s7", "s8", "s9"]
    assert [r[0] for r in trace.spans()] == [first + k for k in range(6, 10)]
    assert trace.dropped() == 6
    trace.clear()
    assert trace.spans() == [] and trace.dropped() == 0


def test_a_synced_span_times_its_wait_and_counts_it(recorder):
    begun, syncs = trace.begun(), trace.host_syncs
    with trace.synced("wait") as s:
        time.sleep(0.001)
    assert trace.host_syncs == syncs + 1 and trace.begun() == begun + 1
    assert s.ms >= 1.0
    assert trace.spans() == [(begun, -1, "wait", s.start_ns, s.end_ns, -1)]


def test_the_epoch_offset_is_read_once_and_matches_the_clocks():
    off = trace.epoch_offset_ns()
    assert trace.epoch_offset_ns() == off
    assert abs(time.perf_counter_ns() + off - time.time_ns()) < 50_000_000


def test_synced_counts_and_records(recorder):
    syncs = trace.host_syncs
    with trace.span("chunk"):
        with trace.synced("fused.readback"):
            pass
        with trace.synced("fused.readback"):
            pass
    assert trace.host_syncs == syncs + 2
    recs = trace.spans()
    assert [r[2] for r in recs] == ["fused.readback", "fused.readback", "chunk"]
    assert recs[0][1] == recs[1][1] == recs[2][0]


def test_an_exception_closes_its_spans(recorder):
    with pytest.raises(KeyError):
        with trace.span("outer"):
            with trace.span("inner"):
                raise KeyError("through the loop")
    assert [r[2] for r in trace.spans()] == ["inner", "outer"]
    with trace.span("after"):
        pass
    assert by_name(trace.spans())["after"][1] == -1  # nothing left open


def test_spans_land_on_the_profilers_clock(recorder):
    """Each recorded span, moved by the offset, starts within 1 ms of the
    host event it opened under the profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(5):
            with trace.span(f"clock.{k}"):
                torch.ones(64).sum()
                time.sleep(0.002)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("clock.")}
    off = trace.epoch_offset_ns()
    recs = [r for r in trace.spans() if r[2].startswith("clock.")]
    assert len(recs) == len(events) == 5
    for _, _, name, start, end, _ in recs:
        e = events[name]
        assert abs(start + off - e.start_ns()) < 1_000_000, name
        assert abs((end - start) - e.duration_ns()) < 1_000_000, name


def test_spans_are_operator_ranges_not_user_annotations(recorder, tmp_path):
    """Under the profiler a span is an operator's range (which the profiler
    does not mirror on the device's timeline, as it does a user
    annotation); without a profiler it opens none."""
    with trace.span("plain") as s:
        pass
    assert s._marker is None and trace.spans()[-1][2] == "plain"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("marked"):
            torch.ones(8).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    cats = [e.get("cat") for e in json.loads(path.read_text())["traceEvents"]
            if e.get("name") == "marked"]
    assert cats == ["cpu_op"]
