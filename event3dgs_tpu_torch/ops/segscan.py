"""Segmented row sums for the rasterizer's gradient reduction (kernel K3).

Counterpart of ``event3dgs_tpu/ops/segscan.py``.  The backward compositing
kernel (K2) writes one gradient row per instance slot; each Gaussian's
gradient is the sum of the rows of its instances, which are contiguous in
expansion (depth-rank) order.  The JAX package gathers the rows into
expansion order, runs a Pallas exclusive prefix scan over all rows, takes
two boundary gathers and a difference, then scatters by rank.  The port
sums each segment directly (``csrc/segsum.cu``): one thread per
(segment, column) adds its rows in expansion order, reading row ``e``
through ``dest[e]`` and writing segment ``s`` to ``order[s]``.

Each segment's rounding error is eps·|segment| instead of the scan's
eps·|prefix| (the weakness the JAX module names), and the sums repeat bit
for bit.  The plain PyTorch version adds the segments in the same order,
vectorised over segments, so the kernel equals it exactly.
"""

from __future__ import annotations

import torch

from event3dgs_tpu_torch.ops import kernels


def _bounds(starts, ends, limit: int):
    s = torch.clamp(starts.long(), 0, limit)
    e = torch.maximum(torch.clamp(ends.long(), 0, limit), s)
    return s, e


def segment_sums_plain(rows, starts, ends, limit: int, dest, order):
    """Plain PyTorch version of K3: [S, W], segment ``s`` in row
    ``order[s]``."""
    n_rows, width = rows.shape
    s, e = _bounds(starts, ends, limit)
    lens = e - s
    rows_pad = torch.cat([rows, rows.new_zeros(1, width)])
    acc = rows.new_zeros(s.shape[0], width)
    max_len = int(lens.max()) if lens.numel() else 0
    for j in range(max_len):
        act = torch.nonzero(lens > j).squeeze(1)
        src = dest[s[act] + j].long()
        src = torch.where((src >= 0) & (src < n_rows), src, n_rows)
        acc[act] = acc[act] + rows_pad[src]
    out = torch.empty_like(acc)
    out[order.long()] = acc
    return out


def segment_sums_kernel(rows, starts, ends, limit: int, dest, order):
    """Launch K3 (``csrc/segsum.cu``) on CUDA tensors."""
    n_rows, width = rows.shape
    n_seg = starts.shape[0]
    kernels.check(rows, torch.float32, "rows")
    kernels.check(starts, torch.int32, "starts", (n_seg,))
    kernels.check(ends, torch.int32, "ends", (n_seg,))
    kernels.check(dest, torch.int32, "dest")
    kernels.check(order, torch.int32, "order", (n_seg,))
    if dest.shape[0] < limit:
        raise ValueError(f"dest: {dest.shape[0]} entries < limit {limit}")
    out = torch.empty(n_seg, width, dtype=torch.float32, device=rows.device)
    kernels.launch(
        "segsum", "e3d_segment_sums",
        rows.data_ptr(), n_rows, width, dest.data_ptr(), starts.data_ptr(),
        ends.data_ptr(), n_seg, limit, order.data_ptr(), out.data_ptr(),
    )
    segment_sums_kernel.launches += 1
    return out


segment_sums_kernel.launches = 0


def segment_sums(rows, starts, ends, limit: int, dest, order):
    """Row sums over the expansion ranges ``[starts[s], ends[s])`` clipped
    to ``[0, limit)``, reading row ``e`` as ``rows[dest[e]]`` (a zero row
    where ``dest[e]`` is out of range) and writing segment ``s`` to output
    row ``order[s]``.  K3 for CUDA tensors, its plain version for CPU ones.
    """
    fn = segment_sums_plain if rows.device.type == "cpu" else \
        segment_sums_kernel
    return fn(rows, starts, ends, limit, dest, order)
