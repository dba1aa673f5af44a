"""The back-to-front transmittance walk of K2 (``csrc/rasterize_bwd.cu``),
which the CPU cannot run, as scalar recurrences over one pixel's stack of
composited layers, three ways:

- log space in float32, as the plain version (``rasterize_tiled.
  composite_backward_plain``) and the TPU kernel walk:
  logT_i = logT_{i+1} - log1p(-alpha_i), T_i = exp(logT_i),
  dL/dalpha_i = gc_i·T_i - S_i/(1 - alpha_i);
- linear space in float32, as K2 walks: r_i = 1/(1 - alpha_i) rounded
  once, T_i = T_{i+1}·r_i, dL/dalpha_i = fma(gc_i, T_i, -S_i·r_i), from
  T = exp(logT_final);
- the same recurrence in float64, the truth.

All three start from the same float32 log T, accumulated front to back as
K1 does, and carry S_{i-1} = fma(w_i, gc_i, S_i) with w_i = alpha_i·T_i.
A fused multiply-add is taken in float64 and rounded once to float32.
The stacks hold up to 2,002 layers: alpha 0.99 down to T = 1e-8 (the
least T K1 leaves, e^-18.4 at its stop); 2,000 layers at alpha 0.004
(T = 3.3e-4), alone and followed by two at 0.99 (T = 3.3e-8); and seeded
mixed alphas cut at K1's stop (log T < -13.8) and closed by one at 0.99
(T near 1e-8).  Imports no JAX."""

import numpy as np
import pytest

F32, F64 = np.float32, np.float64
LOG_T_SKIP = -13.8  # K1's stop
ULP = 2.0 ** -24  # float32's unit roundoff
# the linear walk's error, as a share of the stack's largest value, is no
# more than the log walk's times FACTOR plus FLOOR (a few roundings of that
# value, where both walks are within an ulp or two).  Over 40 seeded mixed
# stacks the linear walk's error was 0.09-2.34 times the log walk's, below
# it on 29, and 4e-7 where it was above twice it; at constant alpha 0.004 a
# quarter of it.
FACTOR = 2.0
FLOOR = 4 * ULP


def fma32(a, b, c):
    return F32(F64(a) * F64(b) + F64(c))


def final_logt(alpha):
    """K1's log T after the stack, in float32."""
    lt = F32(0.0)
    for a in alpha:
        lt = F32(lt + np.log1p(-a))
    return lt


def walk(alpha, gc, s_last, logt_final, space):
    """(w, dL/dalpha) of every layer, walked back to front in ``space``:
    "log" or "linear" (float32), or "float64"."""
    n = len(alpha)
    w, dalpha = np.zeros(n), np.zeros(n)
    carry = F64(s_last) if space == "float64" else F32(s_last)
    if space == "log":
        lt = F32(logt_final)
    elif space == "linear":
        t = F32(np.exp(F32(logt_final)))
    else:
        t = np.exp(F64(logt_final))
    for i in reversed(range(n)):
        a, g = alpha[i], gc[i]
        if space == "log":
            lt = F32(lt - np.log1p(-a))
            ti = F32(np.exp(lt))
            d = fma32(g, ti, -F32(carry / F32(F32(1.0) - a)))
            wi = F32(a * ti)
            carry = fma32(wi, g, carry)
        elif space == "linear":
            r = F32(F32(1.0) / F32(F32(1.0) - a))  # IEEE: __frcp_rn
            t = ti = F32(t * r)
            d = fma32(g, ti, -F32(carry * r))
            wi = F32(a * ti)
            carry = fma32(wi, g, carry)
        else:
            a, g = F64(a), F64(g)
            t = ti = t / (1.0 - a)
            d = g * ti - carry / (1.0 - a)
            wi = a * ti
            carry = carry + wi * g
        w[i], dalpha[i] = wi, d
    return w, dalpha


def mixed_stack(seed):
    """Seeded alphas, most near the 1/255 floor and some up to 0.99,
    composited until K1 would stop, then one layer at 0.99."""
    rng = np.random.default_rng(seed)
    out, lt = [], 0.0
    while len(out) < 2001:
        a = (rng.uniform(1 / 255, 0.006) if rng.random() < 0.99
             else np.exp(rng.uniform(np.log(1 / 255), np.log(0.99))))
        a = F32(a)
        if lt + np.log1p(-F64(a)) < LOG_T_SKIP:
            break
        out.append(a)
        lt += np.log1p(-F64(a))
    return np.array(out + [F32(0.99)], np.float32)


STACKS = {
    "alpha_0.99": lambda: np.full(4, 0.99, np.float32),
    "alpha_0.004": lambda: np.full(2000, 0.004, np.float32),
    "alpha_0.004_then_0.99": lambda: np.r_[np.full(2000, 0.004),
                                           [0.99, 0.99]].astype(np.float32),
    **{f"mixed_seed_{seed}": lambda seed=seed: mixed_stack(seed)
       for seed in range(1, 6)},
}


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_linear_walk_rounds_no_worse_than_log_walk(stack):
    alpha = STACKS[stack]()
    n = len(alpha)
    assert 1 <= n <= 2002 and alpha.min() >= F32(1 / 255)
    assert alpha.max() <= F32(0.99)
    lt = final_logt(alpha)
    t_final = float(np.exp(F64(lt)))
    assert t_final >= 1e-8 * 0.99 and np.isfinite(t_final)
    rng = np.random.default_rng(n)
    gc = rng.uniform(-0.5, 0.5, n).astype(np.float32)
    s_last = F32(rng.uniform(-0.5, 0.5))
    truth = walk(alpha, gc, s_last, lt, "float64")
    log = walk(alpha, gc, s_last, lt, "log")
    lin = walk(alpha, gc, s_last, lt, "linear")
    for what, want, got_log, got_lin in zip(("w", "dalpha"), truth, log, lin):
        assert np.isfinite(got_lin).all()
        top = np.abs(want).max()
        err_log = np.abs(got_log - want).max() / top
        err_lin = np.abs(got_lin - want).max() / top
        assert err_lin <= FACTOR * err_log + FLOOR, (what, err_lin, err_log)
        # at most about one rounding of r and one of T a layer
        assert err_lin <= 2 * (n + 2) * ULP, (what, err_lin, n)
    # w is positive: the linear walk's relative error a layer, too
    rel = np.abs(lin[0] - truth[0]) / truth[0]
    assert rel.max() <= 2 * (n + 2) * ULP


def test_linear_walk_starts_from_the_least_t_without_underflow():
    """At K1's deepest stop the walk's start, e^-18.4, is a normal float32
    and T only grows back to front: every T of the walk is normal."""
    lt = F32(LOG_T_SKIP + np.log(0.01))
    t = F32(np.exp(lt))
    assert t >= np.finfo(np.float32).tiny and np.isclose(t, 1e-8, rtol=0.02)
    for a in np.full(4, 0.99, np.float32):
        t_next = F32(t * F32(F32(1.0) / F32(F32(1.0) - a)))
        assert np.isfinite(t_next) and t_next > t
        t = t_next
    assert np.isclose(t, np.exp(F64(lt) - 4 * np.log1p(-F64(F32(0.99)))),
                      rtol=1e-5)
