"""Device functions of the port by group, as the profiler names them.

Frozen copies of ``event3dgs_tpu_torch/tools/step_split.py``'s
``SPLIT_FUNCTIONS`` and ``tools/kernel_timing.py``'s ``kernel_name`` at
commit 3dea7a328e9275b2036b7ac64470705203e933ed.  A kernel that a later
change adds under another name falls in no group: the per-layer metric that
reads the group then reads less, and the whole-step metrics still count it.
"""

from __future__ import annotations

import re

GROUPS = {
    "K1": ("composite_forward_kernel",),
    "K2": ("composite_backward_kernel",),
    "K3": ("segment_sums_kernel", "ranges_kernel", "row_sums_kernel"),
    "preprocess forward": ("preprocess_forward_kernel",),
    "preprocess backward": ("preprocess_backward_kernel",),
    "Adam": ("adam_update_kernel",),
    "loss": ("event_loss_forward_kernel", "event_loss_backward_kernel",
             "photometric_loss_forward_kernel",
             "photometric_loss_backward_kernel"),
    "binning": ("gaussian_table_kernel", "radix_histogram_kernel",
                "radix_pass_kernel", "depth_offsets_kernel",
                "expand_kernel", "segment_count_kernel", "scan_kernel",
                "rank_kernel"),
}


def kernel_name(key: str) -> str:
    """A device kernel's function name from the profiler's key
    (namespaces, template arguments and parameters stripped)."""
    key = key.replace("(anonymous namespace)::", "")
    m = re.match(r"(?:void )?([\w:]+?)(?:<.*>)?\(", key)
    return m.group(1).split("::")[-1] if m else key


def group_of(name: str) -> str:
    """The group of a function name as :func:`kernel_name` gives it: one of
    :data:`GROUPS`, "copies" for memory copies and sets, else "other"."""
    for group, functions in GROUPS.items():
        if name in functions:
            return group
    low = name.lower()
    if low.startswith("memcpy") or low.startswith("memset"):
        return "copies"
    return "other"
