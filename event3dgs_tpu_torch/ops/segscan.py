"""Segmented row sums for the rasterizer's gradient reduction (kernel K3).

Counterpart of ``event3dgs_tpu/ops/segscan.py``.  The backward compositing
kernel (K2) writes one gradient row per instance slot; each Gaussian's
gradient is the sum of the rows of its instances, which are contiguous in
expansion (depth-rank) order.  The JAX package gathers the rows into
expansion order, runs a Pallas exclusive prefix scan over all rows, takes
two boundary gathers and a difference, then scatters by rank.  The port
sums each segment directly (``csrc/segsum.cu``), in one of two orders.
In rank order one thread per (segment, column) adds its rows in expansion
order, reading row ``e`` through ``dest[e]`` and writing segment ``s`` to
``order[s]``: one launch, but each 36-byte output row lands at a random
place, which past the card's L2 costs a read and a merge of its two
part-written 32-byte sectors.  In output order (rows of 9 floats) a first
launch writes each segment's clipped range to row ``order[s]`` of a
table, then one owner thread per output row adds its rows in expansion
order and each block writes its output rows whole.  The wrapper takes
output order where the sums outgrow :data:`BY_OUTPUT_L2` of the L2
(:func:`by_output_order`).

Each segment's rounding error is eps·|segment| instead of the scan's
eps·|prefix| (the weakness the JAX module names), and the sums repeat bit
for bit.  The plain PyTorch version adds the segments in the same order,
vectorised over segments, so the kernel equals it exactly.
"""

from __future__ import annotations

import torch

from event3dgs_tpu_torch.ops import kernels


# the share of the card's L2 past which the [N, 9] sums are taken in output
# order (tools/kernel_timing.py --k3 times both orders by size: on an H100
# the output order wins from 300k-350k Gaussians, 11-13 MB of sums, where
# the rows, dest and sums of the rank order outgrow the L2)
BY_OUTPUT_L2 = 0.2


def by_output_order(width: int, n_seg: int, l2_bytes: int) -> bool:
    """Whether K3 takes its sums in output order: rows of 9 floats whose
    [n_seg, 9] float32 sums outgrow :data:`BY_OUTPUT_L2` of ``l2_bytes``."""
    return width == 9 and n_seg * width * 4 > BY_OUTPUT_L2 * l2_bytes


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


def segment_sums_kernel(rows, starts, ends, limit: int, dest, order,
                        by_output: bool | None = None):
    """Launch K3 (``csrc/segsum.cu``) on CUDA tensors, in output order
    where ``by_output`` says so (None: :func:`by_output_order`)."""
    n_rows, width = rows.shape
    n_seg = starts.shape[0]
    kernels.check(rows, torch.float32, "rows")
    kernels.check(starts, torch.int32, "starts", (n_seg,))
    kernels.check(ends, torch.int32, "ends", (n_seg,))
    kernels.check(dest, torch.int32, "dest")
    kernels.check(order, torch.int32, "order", (n_seg,))
    if dest.shape[0] < limit:
        raise ValueError(f"dest: {dest.shape[0]} entries < limit {limit}")
    if by_output is None:
        by_output = by_output_order(width, n_seg, torch.cuda.get_device_properties(
            rows.device).L2_cache_size)
    elif by_output and width != 9:
        raise ValueError(f"output order takes rows of 9 floats, not {width}")
    out = torch.empty(n_seg, width, dtype=torch.float32, device=rows.device)
    if by_output:
        ranges = torch.empty(n_seg, 2, dtype=torch.int32, device=rows.device)
        kernels.launch(
            "segsum", "e3d_segment_sums_by_output",
            rows.data_ptr(), n_rows, dest.data_ptr(), starts.data_ptr(),
            ends.data_ptr(), n_seg, limit, order.data_ptr(), out.data_ptr(),
            ranges.data_ptr(),
        )
    else:
        kernels.launch(
            "segsum", "e3d_segment_sums",
            rows.data_ptr(), n_rows, width, dest.data_ptr(),
            starts.data_ptr(), ends.data_ptr(), n_seg, limit,
            order.data_ptr(), out.data_ptr(),
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
