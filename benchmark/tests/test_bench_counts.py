"""The frozen counts equal the port's tools at fixed shapes, as copied."""

from __future__ import annotations

import pytest
import torch

from benchmark.counts import bounds as b
from benchmark.counts import groups
from event3dgs_tpu_torch.tools import kernel_timing as kt
from event3dgs_tpu_torch.tools import step_split

SHAPES = [(100_000, 50, 1920, 1080), (2_097_152, 1450, 1600, 900),
          (3_145_728, 1700, 1600, 1063)]


@pytest.mark.parametrize("n,tiles,w,h", SHAPES)
def test_bytes_and_operations(n, tiles, w, h):
    live = 2 * n
    pairs = (3 * n, 5 * n, 40 * n, 7 * n)
    for backward in (False, True):
        assert b.composite_bytes(live, n, tiles, w, h, backward) == \
            kt.composite_bytes(live, n, tiles, w, h, backward)
        assert b.preprocess_bytes(n, 16, 3, backward, 3, True) == \
            kt.preprocess_bytes(n, 16, 3, backward, 3, True)
        assert b.preprocess_ops(n, 3, backward, 3) == kt.preprocess_ops(n, 3, backward, 3)
        assert b.loss_bound(w * h, (3, 3, 3), backward, 3) == \
            kt.loss_bound(w * h, (3, 3, 3), backward, 3)
        for ch in (1, 3):
            assert b.photometric_bound(w * h, ch, backward) == \
                kt.photometric_bound(w * h, ch, backward)
    for table in ((b.K1_PAIR_OPS, kt.K1_PAIR_OPS), (b.K2_PAIR_OPS, kt.K2_PAIR_OPS)):
        assert table[0] == table[1]
        assert b.pair_ops(pairs, table[0]) == kt.pair_ops(pairs, table[1])
    assert b.segment_sums_bytes(live, live, n) == kt.segment_sums_bytes(live, live, n)
    assert b.adam_bound(59 * n) == kt.adam_bound(59 * n)
    assert b.depth_order_bytes(n, 2 * n) == kt.depth_order_bytes(n, 2 * n)
    offsets = torch.arange(0, 2 * n + 1, 2, dtype=torch.int32)
    assert b.expansion_bytes(offsets.tolist(), 2 * n, tiles) == \
        kt.expansion_bytes(offsets, 2 * n, tiles)
    assert b.bound_ms(123_456_789, (1e10, 1e9)) == kt.bound_ms(123_456_789, (1e10, 1e9))
    assert (b.PEAK_BYTES_PER_S, b.PEAK_FP32_PER_S, b.PEAK_SFU_PER_S) == \
        (kt.PEAK_BYTES_PER_S, kt.PEAK_FP32_PER_S, kt.PEAK_SFU_PER_S)


def test_tables_bound_is_path_bounds():
    n = 100_000
    pb = kt.path_bounds(n, 2 * n, torch.arange(n + 1, dtype=torch.int32) * 2,
                        2 * n, (0, 0, 10 * n, 0), 2040, 1920, 1080)
    assert b.gaussian_tables_bound(n) == pb["K4 gaussian_tables"]


def test_groups_are_step_splits():
    renamed = {"binning kernels": "binning"}
    assert {renamed.get(k, k): v for k, v in step_split.SPLIT_FUNCTIONS.items()} \
        == groups.GROUPS
    for key in ("void composite_forward_kernel<3>(float const*, int)",
                "void at::native::(anonymous namespace)::foo<float>(int)",
                "Memcpy DtoH (Device -> Pageable)"):
        assert groups.kernel_name(key) == kt.kernel_name(key)
    assert groups.group_of("radix_pass_kernel") == "binning"
    assert groups.group_of("Memcpy DtoH (Device -> Pageable)") == "copies"
