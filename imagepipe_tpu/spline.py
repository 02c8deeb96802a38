"""Monotone cubic spline (Fritsch-Carlson) for tone curves.

Re-design of SplineFunc (/root/reference/src/ops/curves.rs:59-158). The
reference binary-searches the knot interval per pixel on the CPU; curves have
only a handful of knots, so here the coefficients are computed host-side in
float32 (tiny) and evaluation is a vectorized searchsorted + Horner step on
device -- XLA fuses it into the surrounding elementwise chain.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

__all__ = ["SplineFunc", "eval_spline_arrays"]


def eval_spline_arrays(xs, ys, c1, c2, c3, n_knots: int, v):
    """Gather-free monotone-spline evaluation over TRACED coefficient arrays
    with a static knot count (interval selection unrolls into compare-
    selects). Shared by the staged curves op and the fused engine so their
    numerics cannot drift; matches SplineFunc.interpolate and the reference's
    exact-knot/clamp semantics (curves.rs:126-157)."""
    n_int = n_knots - 1
    idx = jnp.zeros(v.shape, jnp.int32)
    for j in range(1, n_knots):
        idx = idx + (v >= xs[j]).astype(jnp.int32)
    idx = jnp.clip(idx, 0, n_int - 1)

    def sel(tab):
        acc = jnp.broadcast_to(tab[0], v.shape)
        for j in range(1, n_int):
            acc = jnp.where(idx == j, tab[j], acc)
        return acc

    d = v - sel(xs)
    y = sel(ys) + sel(c1) * d + sel(c2) * d * d + sel(c3) * d * d * d
    y = jnp.where(v >= xs[n_knots - 1], ys[n_knots - 1], y)
    y = jnp.where(v <= xs[0], ys[0], y)
    return y

_f32 = np.float32


class SplineFunc:
    """Monotone cubic interpolator over [0,1] control points.

    Auto-anchors (0,0) and (1,1) exactly like SplineFunc::new
    (curves.rs:68-76); clamps outside [first.x, last.x] (curves.rs:126-137).
    """

    def __init__(self, p):
        pts = []
        p = [(float(x), float(y)) for (x, y) in p]
        if len(p) == 0 or (p[0][0] > 0.0 and p[0][1] > 0.0):
            pts.append((0.0, 0.0))
        pts.extend(p)
        if len(p) == 0 or (p[-1][0] < 1.0 and p[-1][1] < 1.0):
            pts.append((1.0, 1.0))

        xs = np.array([pt[0] for pt in pts], dtype=_f32)
        ys = np.array([pt[1] for pt in pts], dtype=_f32)

        dxs = xs[1:] - xs[:-1]
        dys = ys[1:] - ys[:-1]
        slopes = dys / dxs

        # Degree-1 coefficients (curves.rs:91-104).
        c1s = [slopes[0]]
        for i in range(len(dxs) - 1):
            m, nxt = slopes[i], slopes[i + 1]
            if m * nxt <= 0.0:
                c1s.append(_f32(0.0))
            else:
                dx, dxnext = dxs[i], dxs[i + 1]
                common = dx + dxnext
                c1s.append(_f32(3.0) * common / ((common + dxnext) / m + (common + dx) / nxt))
        c1s.append(slopes[-1])
        c1s = np.array(c1s, dtype=_f32)

        # Degree-2/3 coefficients (curves.rs:107-116).
        invdx = _f32(1.0) / dxs
        common = c1s[:-1] + c1s[1:] - slopes - slopes
        c2s = (slopes - c1s[:-1] - common) * invdx
        c3s = common * invdx * invdx

        self.xs = xs
        self.ys = ys
        self.c1s = c1s
        self.c2s = c2s.astype(_f32)
        self.c3s = c3s.astype(_f32)

    def interpolate(self, val):
        """Vectorized spline evaluation matching SplineFunc::interpolate
        (curves.rs:126-157): clamp to endpoint y outside the knot range,
        exact knot y at knots, cubic in between.

        Gather-free: tone curves have a handful of knots, so interval
        selection unrolls into where-chains of compare-selects that fuse
        with the surrounding elementwise work.
        """
        val = jnp.asarray(val, dtype=jnp.float32)
        xs, ys = self.xs, self.ys
        n_int = len(self.c3s)

        # Interval index = (#knots <= val) - 1, clamped -- identical to
        # searchsorted(side='right')-1, so exact-knot inputs get diff == 0
        # (the reference's exact-match branch, curves.rs:144-150).
        idx = jnp.zeros(val.shape, jnp.int32)
        for j in range(1, len(xs)):
            idx = idx + (val >= xs[j]).astype(jnp.int32)
        idx = jnp.clip(idx, 0, n_int - 1)

        def sel(table):
            acc = jnp.full(val.shape, jnp.float32(table[0]))
            for j in range(1, n_int):
                acc = jnp.where(idx == j, jnp.float32(table[j]), acc)
            return acc

        x0 = sel(xs[:n_int])
        diff = val - x0
        y = (sel(ys[:n_int]) + sel(self.c1s[:n_int]) * diff
             + sel(self.c2s) * diff * diff
             + sel(self.c3s) * diff * diff * diff)
        y = jnp.where(val >= xs[-1], jnp.float32(ys[-1]), y)
        y = jnp.where(val <= xs[0], jnp.float32(ys[0]), y)
        return y

    def __call__(self, val):
        return self.interpolate(val)
