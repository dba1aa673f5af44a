"""Several train steps between host events with no host launch per kernel:
the port's ``pipeline.fused_steps``.

The JAX loop runs up to N steps between host events as one ``lax.scan``
dispatch (``event3dgs_tpu/train/loop.py``).  Here the counterpart is a CUDA
graph of one :class:`~event3dgs_tpu_torch.train.step.GraphTrainStep` step
(three renders' forward and backward, the loss, Adam, the densify stats,
the kernels K1-K6 inside), captured once over static buffers and replayed
once per step.  :class:`FusedSteps` holds those buffers: the state it
trains, the row table of a chunk, the cursor that picks the row, the loss
history and the metrics.  A chunk of k steps is one copy of its table to
the device, k replays and one read of the k losses.

The graph bakes in every address it reads, so it is captured again only
when one of them changes: a rebuilt step (a new instance cap), a new
capacity, other scene data.  :class:`GraphCache` keeps the one graph of a
training run, keyed on those objects (not on ``id()``, which a new object
can reuse).  On the CPU there is no graph: the same step runs eagerly, k
times per chunk, through the same table.  On a CUDA device a failed capture
or replay raises; nothing falls back to eager steps.
"""

from __future__ import annotations

from typing import Optional

import torch

from event3dgs_tpu_torch.train.state import (
    SceneData,
    TrainState,
    copy_tree_,
    map_tensors,
)
from event3dgs_tpu_torch.train.step import GraphTrainStep, StepSlots
from event3dgs_tpu_torch.utils import trace

# eager steps on a side stream before a capture: they load every kernel
# library and module (a launch may not load one during capture) and make
# the constants and autograd's state the step needs (PyTorch's CUDA graph
# documentation asks for a warm-up on a side stream)
WARMUP_STEPS = 2


class FusedSteps:
    """Static buffers for ``step`` on ``state``'s device and capacity, and
    on a CUDA device the CUDA graph of one step over them.

    ``state`` here is the live training state (``self.state``): the steps
    write into it in place.  :meth:`load` copies another state of the same
    capacity in; :meth:`run` runs a chunk.  ``replays`` counts the graph's
    replays (the kernels' own launch counts see only the warm-up and the
    capture).
    """

    def __init__(self, step: GraphTrainStep, state: TrainState,
                 data: SceneData, rows: int):
        dev = state.params.device
        self.step, self.data = step, data
        self.capacity = state.params.capacity
        self.state = map_tensors(torch.clone, state)
        self.table = torch.zeros(rows, step.columns, dtype=torch.float32,
                                 device=dev)
        self.cursor = torch.zeros(1, dtype=torch.int64, device=dev)
        self.slots = StepSlots(rows, dev)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.capture_ms: Optional[float] = None
        self.replays = 0
        if dev.type == "cuda":
            self._capture(state)

    def _call(self) -> None:
        self.step(self.state, self.data, self.table, self.cursor, self.slots)

    def _capture(self, state: TrainState) -> None:
        """Warm up on a side stream, capture one step, then load ``state``
        again (the warm-up steps changed the buffers).  ``capture_ms`` is
        the ``fused.capture`` span's duration."""
        with trace.synced("fused.capture") as capture:
            side = torch.cuda.Stream(self.table.device)
            side.wait_stream(torch.cuda.current_stream(self.table.device))
            with torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    self.cursor.zero_()
                    self._call()
            torch.cuda.current_stream(self.table.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            self.cursor.zero_()
            with torch.cuda.graph(graph):
                self._call()
            self.graph = graph
            self.load(state)
            torch.cuda.synchronize(self.table.device)
        self.capture_ms = capture.ms

    def load(self, state: TrainState) -> None:
        """Make ``state`` (same capacity) the live state: copied in."""
        if state.params.capacity != self.capacity:
            raise ValueError(f"state of capacity {state.params.capacity} "
                             f"for buffers of {self.capacity}")
        copy_tree_(self.state, state)

    def run(self, rows: torch.Tensor) -> list:
        """Run the steps of the table rows ``rows`` ([k, columns] float32
        on the CPU, :meth:`GraphTrainStep.row`) in order: one copy to the
        device, k graph replays (eager steps on the CPU), one read of the k
        losses, which it returns: the spans ``fused.upload``,
        ``fused.launch`` and ``fused.readback``, the first and the last a
        host wait.  Advances ``state.step`` by k."""
        k = rows.shape[0]
        if not 0 < k <= self.table.shape[0]:
            raise ValueError(f"{k} rows for a table of {self.table.shape[0]}")
        with trace.synced("fused.upload"):  # a pageable copy waits
            self.table[:k].copy_(rows)
            self.cursor.zero_()
        with trace.span("fused.launch", n=k):
            for _ in range(k):
                if self.graph is None:
                    self._call()
                else:
                    self.graph.replay()
                    self.replays += 1
        self.state.step = self.state.step + k
        with trace.synced("fused.readback"):
            return self.slots.history[:k].tolist()

    def release(self) -> None:
        """Free the graph and its memory pool."""
        if self.graph is not None:
            self.graph.reset()
            self.graph = None


class GraphCache:
    """The :class:`FusedSteps` of a training run: at most one, kept while
    the step object, the capacity, the scene data and the table's rows stay
    the same.  ``captures`` counts the CUDA graphs it captured."""

    def __init__(self):
        self.entry: Optional[FusedSteps] = None
        self.captures = 0

    def get(self, step: GraphTrainStep, state: TrainState, data: SceneData,
            rows: int) -> FusedSteps:
        """Steps for ``step`` on ``data`` with ``state`` loaded: the cached
        ones where they fit (no capture), else new ones, after the old
        graph is freed: the ``fused.get`` span."""
        with trace.span("fused.get"):
            e = self.entry
            if (e is not None and e.step is step and e.data is data
                    and e.capacity == state.params.capacity
                    and e.table.shape[0] == rows):
                e.load(state)
                return e
            self.clear()
            self.entry = FusedSteps(step, state, data, rows)
            self.captures += self.entry.graph is not None
            return self.entry

    def clear(self) -> None:
        if self.entry is not None:
            self.entry.release()
            self.entry = None
