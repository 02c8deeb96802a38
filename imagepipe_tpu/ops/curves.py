"""Stage 5: tone curve on the L channel.

Re-design of OpBaseCurve (/root/reference/src/ops/curves.rs:5-56): spline
coefficients computed host-side, evaluation fused into the device chain.
Exposure scales each control point's y by 2^exposure before fitting.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from .base import ImageOp
from ..buffer import OpBuffer
from ..hasher import pack_f32, pack_pairs
from ..sources import ImageSource
from ..spline import SplineFunc

__all__ = ["OpBaseCurve"]


@partial(jax.jit, static_argnames=("n_knots",))
def _curve_kernel(data, xs, ys, c1, c2, c3, *, n_knots):
    """Spline on the L plane with TRACED coefficient arrays: interactive
    exposure/curve edits must not retrace (baked-constant coefficients would
    trigger a multi-second remote recompile per slider step)."""
    from ..spline import eval_spline_arrays

    return data.at[0].set(eval_spline_arrays(xs, ys, c1, c2, c3, n_knots, data[0]))


class OpBaseCurve(ImageOp):
    NAME = "basecurve"

    def __init__(self, img: ImageSource):
        self.exposure = 0.0
        if img.is_raw:
            # Default slope from linear raw toward a natural look
            # (curves.rs:14-19).
            self.points = [(0.50, 0.60)]
        else:
            self.points = []

    def serialize_binary(self) -> bytes:
        return pack_f32(self.exposure) + pack_pairs(self.points)

    def to_settings_dict(self) -> dict:
        return {"exposure": float(self.exposure),
                "points": [[float(a), float(b)] for a, b in self.points]}

    def load_settings_dict(self, d: dict) -> None:
        self.exposure = float(d["exposure"])
        self.points = [(float(a), float(b)) for a, b in d["points"]]

    def get_spline(self) -> SplineFunc:
        return SplineFunc(self.points)

    def device_chain(self, globals_, meta):
        if len(self.points) == 0 and abs(self.exposure) < 0.001:
            return (("basecurve", None), None, (), meta)
        import numpy as np

        scale = math.pow(2.0, self.exposure)
        func = SplineFunc([(x, y * scale) for (x, y) in self.points])
        n_knots = len(func.xs)
        # ONE packed [5, n] coefficient table, not five arrays: every numpy
        # jit argument is a separate blocking host->device transfer per
        # edit. c2/c3 have n-1 entries; the zero pad is never indexed
        # (eval stops at n_int-1).
        coeffs = np.zeros((5, n_knots), np.float32)
        coeffs[0] = func.xs
        coeffs[1] = func.ys
        coeffs[2] = func.c1s
        coeffs[3, :n_knots - 1] = func.c2s
        coeffs[4, :n_knots - 1] = func.c3s

        def fn(data, coeffs_):
            from ..spline import eval_spline_arrays

            return data.at[0].set(
                eval_spline_arrays(coeffs_[0], coeffs_[1], coeffs_[2],
                                   coeffs_[3], coeffs_[4], n_knots, data[0]))

        return (("basecurve", n_knots), fn, (coeffs,), meta)

    def run(self, globals_, buf: OpBuffer) -> OpBuffer:
        if len(self.points) == 0 and abs(self.exposure) < 0.001:
            return buf
        scale = math.pow(2.0, self.exposure)
        final_points = [(x, y * scale) for (x, y) in self.points]
        func = SplineFunc(final_points)
        # Coefficients go to the jit as HOST numpy: eager jnp.asarray
        # would commit five separate device transfers per edit before the
        # dispatch bundles its arguments anyway.
        import numpy as np

        data = _curve_kernel(
            buf.data, np.asarray(func.xs, np.float32),
            np.asarray(func.ys, np.float32),
            np.asarray(func.c1s, np.float32),
            np.asarray(func.c2s, np.float32),
            np.asarray(func.c3s, np.float32),
            n_knots=len(func.xs))
        return buf.with_data(data)
