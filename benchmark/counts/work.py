"""The least time of a train step's kernels, and the whole step's FP32
operations, from the frozen counts (``bounds``) and the pairs that the
reference counted at the step's views (``reference.splats.pair_counts``).
"""

from __future__ import annotations

from benchmark.counts import bounds as b


def _view(n: int, sh: int, pairs: dict, width: int, height: int,
          backward: bool) -> dict:
    """{kernel: (bytes, (FP32, SFU))} of one view's compositing."""
    by_kind = (0, 0, pairs["composited"])
    live, tiles = pairs["instances"], pairs["tiles"]
    out = {"K1": (b.composite_bytes(live, n, tiles, width, height),
                  b.pair_ops(by_kind, b.K1_PAIR_OPS)),
           "tables": b.gaussian_tables_bound(n)}
    if backward:
        out["K2"] = (b.composite_bytes(live, n, tiles, width, height, True),
                     b.pair_ops(by_kind, b.K2_PAIR_OPS))
        out["K3"] = (b.segment_sums_bytes(live, live, n), (live * b.NGRAD, 0))
    return out


def _least(items) -> float:
    return sum(b.bound_ms(nb, ops)[0] for nb, ops in items)


def train_step(mode: str, n: int, sh: int, views: list, width: int,
               height: int) -> dict:
    """Least ms of K1, K2 and Adam in one step, and the step's FP32
    operations, for ``views`` (the pair counts of each render)."""
    per = [_view(n, sh, p, width, height, True) for p in views]
    coeffs = (sh + 1) ** 2
    v = len(views)
    pre_f = (b.preprocess_bytes(n, coeffs, sh, views=v, tap=True),
             b.preprocess_ops(n, sh, views=v))
    pre_b = (b.preprocess_bytes(n, coeffs, sh, backward=True, views=v),
             b.preprocess_ops(n, sh, backward=True, views=v))
    floats = n * 3 * (1 + coeffs) + n * (3 + 4 + 1) + (mode == "event")
    adam = b.adam_bound(floats)
    pixels = width * height
    if mode == "event":
        loss = [b.loss_bound(pixels, (3, 3, 3), False, 3),
                b.loss_bound(pixels, (3, 3, 3), True, 3)]
    else:
        loss = [b.photometric_bound(pixels, 3, False),
                b.photometric_bound(pixels, 3, True)]
    fp32 = (pre_f[1][0] + pre_b[1][0] + adam[1][0] + sum(x[1][0] for x in loss)
            + sum(k[1][0] for p in per for k in p.values()))
    return {"k1_ms": _least(p["K1"] for p in per),
            "k2_ms": _least(p["K2"] for p in per),
            "adam_ms": _least([adam]),
            "fp32_ops": fp32}

