"""The yardstick's work counts: the bytes and operations each kernel of the
port's step must at least move and do, and the peaks of the card.

Frozen copies of ``event3dgs_tpu_torch/tools/kernel_timing.py`` at commit
3dea7a328e9275b2036b7ac64470705203e933ed (``bound_ms``, ``pair_ops`` with
``K1_PAIR_OPS``/``K2_PAIR_OPS``, ``composite_bytes``, ``expansion_bytes``,
``segment_sums_bytes``, ``preprocess_bytes``/``_ops``, ``adam_bound``,
``loss_bound``, ``photometric_bound``, ``depth_order_bytes``, the peaks),
rewritten to import nothing of the port: ``SEGMENT`` and ``NGRAD`` are
copied beside them.  The program may change; these stay put, so a later
change reads against the same yardstick.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# FP32 outside the tensor cores: 67 TFLOP/s with an FMA as two operations;
# the kernels are built with -fmad=false, so one instruction is one operation
PEAK_FP32_PER_S = 33.5e12
PEAK_SFU_PER_S = PEAK_FP32_PER_S / 8  # exp, log, reciprocal: 16 of 128 lanes
# (FP32, SFU) operations per (pixel, instance) pair a compositing kernel
# visits: skipped at power > 0, skipped at raw < 1/255, composited
K1_PAIR_OPS = ((10, 0), (12, 1), (23, 3))
K2_PAIR_OPS = ((10, 0), (12, 1), (38, 4))
COMPOSITED = 2
SEGMENT = 2048  # ids per block of the counting sort's kernels
NGRAD = 9  # gradient floats per instance slot (K2's rows)
ADAM_BYTES_PER_FLOAT = (4 + 3) * 4
ADAM_OPS_PER_FLOAT = (10, 4)
LOSS_PIXEL_OPS = {False: (25, 5), True: (33, 9)}
LOSS_GT_L_OPS = 5
LOSS_DEBLUR_OPS = {False: 6, True: 9}
LOSS_PARTIALS_OPS = {False: (6, 1), True: (12, 1)}
PHOTO_VALUE_OPS = {False: (245, 4), True: (136, 0)}
PHOTO_LUMA_OPS = 8
PHOTO_PARTIALS_OPS = {False: (6, 1), True: (15, 1)}


def segments(n_ids: int) -> int:
    return max(-(-n_ids // SEGMENT), 1)


def pair_ops(pairs, table, kinds=(COMPOSITED,)):
    """(FP32, SFU) operations of the pairs of ``kinds`` (counts by kind)."""
    return (sum(pairs[k] * table[k][0] for k in kinds),
            sum(pairs[k] * table[k][1] for k in kinds))


def bound_ms(nbytes, ops):
    """The least time for ``nbytes`` moved and (FP32, SFU) ``ops``, and
    which of the two bounds it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(ops[0] / PEAK_FP32_PER_S, ops[1] / PEAK_SFU_PER_S) * 1e3
    return max(t_bytes, t_ops), "operations" if t_ops > t_bytes else "bytes"


def composite_bytes(live: int, n: int, num_tiles: int, width: int,
                    height: int, backward: bool = False) -> int:
    """Bytes K1 (or K2) must move."""
    common = live * 4 + n * 48 + num_tiles * 8
    if not backward:
        return common + width * height * 20
    return common + width * height * 24 + live * 9 * 4


def expansion_bytes(offsets, cap: int, num_tiles: int,
                    count_rows: bool = True) -> int:
    """Bytes K4 must move at its depth offsets ``offsets`` [N+1]."""
    off = [int(x) for x in offsets]
    capped = min(off[-1], cap)
    live_ranks = sum(1 for a, b in zip(off[:-1], off[1:]) if a < capped and b > a)
    rows = -(-capped // SEGMENT) * num_tiles * 4 if count_rows else 0
    return live_ranks * (48 + 4 + 4) + cap * 8 + rows


def segment_sums_bytes(live: int, slots: int, n: int) -> int:
    """Bytes K3 must move."""
    return live * 9 * 4 + slots * 4 + (n + 1) * 4 + n * 4 + n * 9 * 4


def preprocess_bytes(n: int, coeffs: int, sh_degree: int,
                     backward: bool = False, views: int = 1,
                     tap: bool = False) -> int:
    """Bytes the preprocess forward (or backward) kernel must move."""
    used = (sh_degree + 1) ** 2 * 12
    if not backward:
        return n * (12 + 12 + 16 + 4 + used + (8 if tap else 0)
                    + views * (8 + 4 + 12 + 4 + 1 + 12 + 48))
    return n * (12 + 12 + 16 + used + views * (1 + 8 + 12 + 12)
                + 12 + 12 + 16 + coeffs * 12)


def preprocess_ops(n: int, sh_degree: int, backward: bool = False,
                   views: int = 1):
    """(FP32, SFU) operations of the preprocess forward (or backward)."""
    coeffs = (sh_degree + 1) ** 2
    if not backward:
        return (views * n * (170 + 6 * coeffs), views * n * 16)
    return (views * n * (2 * 170 + 12 * coeffs), views * n * 12)


def adam_bound(floats: int):
    """(bytes, (FP32, SFU) operations) of the Adam update of ``floats``."""
    return (floats * ADAM_BYTES_PER_FLOAT,
            (floats * ADAM_OPS_PER_FLOAT[0], floats * ADAM_OPS_PER_FLOAT[1]))


def loss_bound(pixels: int, channels, backward: bool = False,
               partials: int = 0):
    """(bytes, (FP32, SFU) operations) of one event loss kernel."""
    deblur = len(channels) > 3
    floats = 9 + partials + sum(channels)
    if backward:
        floats += 9 + partials
    scalars = 4 * (4 if backward else 6)
    fp32, sfu = LOSS_PIXEL_OPS[backward]
    fp32 += LOSS_GT_L_OPS * sum(c == 3 for c in channels[:2])
    fp32 += LOSS_DEBLUR_OPS[backward] if deblur else 0
    fp32 += LOSS_PARTIALS_OPS[backward][0] * partials
    sfu += LOSS_PARTIALS_OPS[backward][1] * partials
    return 4 * floats * pixels + scalars, (fp32 * pixels, sfu * pixels)


def photometric_bound(pixels: int, channels: int = 3, backward: bool = False,
                      gt_channels: int = 3, partials: bool = True):
    """(bytes, (FP32, SFU) operations) of one SSIM loss kernel."""
    render = 3 + partials
    floats = render + gt_channels + 3 * channels
    if backward:
        floats += render
    scalars = 4 * (1 if backward else 2)
    fp32, sfu = PHOTO_VALUE_OPS[backward]
    fp32, sfu = fp32 * channels, sfu * channels
    if channels == 1:
        fp32 += PHOTO_LUMA_OPS * (1 + (gt_channels == 3)) + 3 * backward
    if partials:
        fp32 += PHOTO_PARTIALS_OPS[backward][0]
        sfu += PHOTO_PARTIALS_OPS[backward][1]
    return 4 * floats * pixels + scalars, (fp32 * pixels, sfu * pixels)


def depth_order_bytes(n: int, cap: int):
    """(bytes, operations) of the depth order of ``n`` Gaussians."""
    return n * 16 + 4 + segments(cap) * 4, (0, 0)


def gaussian_tables_bound(n: int):
    """The binning's table kernel: per Gaussian 33 bytes read, 56 written;
    at least 60 FP32 and 7 SFU operations (kernel_timing.path_bounds)."""
    return n * (33 + 56), (60 * n, 7 * n)
