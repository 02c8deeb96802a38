"""Full-resolution CFA demosaic as a vectorized 3x3 stencil.

Re-design of `full()` (/root/reference/src/ops/demosaic.rs:67-119). The
reference walks pixels scalar-wise consulting a 48x48x9 neighbor-color
lookup; here the same lookup drives nine shifted whole-image accumulations --
each of the four color planes is a sum of masked shifts that XLA fuses into
one pass over the sensor plane. Works for any periodic CFA (Bayer, X-Trans,
8x2) with identical edge handling.

The neighbor-color map is materialized by TILING the 48x48 periodic pattern
(broadcast+reshape), so the stencil is a pure elementwise fusion with no
per-pixel gathers.
"""

from __future__ import annotations

from functools import lru_cache, partial

import numpy as np
import jax
import jax.numpy as jnp

from ..buffer import OpBuffer
from ..raw import CFA, PATTERN_TILE

__all__ = ["demosaic_full", "neighbor_color_lookup", "stencil_demosaic"]

# 3x3 neighborhood offsets in the reference's order (demosaic.rs:70-74).
OFFSETS_3X3 = [(-1, -1), (-1, 0), (-1, 1),
               (0, -1), (0, 0), (0, 1),
               (1, -1), (1, 0), (1, 1)]


@lru_cache(maxsize=64)
def _lookup_cached(cfa_name: str) -> np.ndarray:
    cfa = CFA(cfa_name)
    t = PATTERN_TILE
    lut = np.zeros((t, t, 9), dtype=np.uint8)
    for row in range(t):
        for col in range(t):
            pixcolor = cfa.color_at(row, col)
            for i, (dy, dx) in enumerate(OFFSETS_3X3):
                ocolor = cfa.color_at(row + t + dy, col + t + dx)
                # Same-color neighbors (other than the center itself) are
                # tagged 4 = discard so the center keeps its own measured
                # value (demosaic.rs:87).
                if ocolor != pixcolor or (dx == 0 and dy == 0):
                    lut[row, col, i] = ocolor
                else:
                    lut[row, col, i] = 4
    return lut


def neighbor_color_lookup(cfa: CFA) -> np.ndarray:
    """[48,48,9] neighbor-color table, exactly demosaic.rs:76-90."""
    return _lookup_cached(cfa.name)


def _tiled_colors(cfa_name: str, i: int, height: int, width: int):
    """Neighbor-color map for offset i as a [height, width] u8 array built by
    tiling the periodic 48x48 pattern (no gathers)."""
    lut = _lookup_cached(cfa_name)[:, :, i]
    reps = (-(-height // PATTERN_TILE), -(-width // PATTERN_TILE))
    return jnp.tile(jnp.asarray(lut), reps)[:height, :width]


def stencil_demosaic_planes(plane, cfa_name: str, height: int, width: int):
    """[H,W] f32 sensor plane -> list of four [H,W] RGBE planes."""
    out = stencil_demosaic(plane, cfa_name, height, width, stacked=False)
    return out


def stencil_demosaic(plane, cfa_name: str, height: int, width: int, stacked=True):
    """[H,W] f32 sensor plane -> [H,W,4] RGBE. Shared by the staged op and
    the fused engine (identical trace => identical bits)."""
    f = jnp.float32
    padded = jnp.pad(plane, 1)
    vmask = jnp.pad(jnp.ones((height, width), f), 1)
    # Colors present per offset (host-side): skip always-empty (i, c) pairs.
    lut = _lookup_cached(cfa_name)
    sums = [jnp.zeros((height, width), f) for _ in range(4)]
    counts = [jnp.zeros((height, width), f) for _ in range(4)]
    for i, (dy, dx) in enumerate(OFFSETS_3X3):
        val = jax.lax.dynamic_slice(padded, (1 + dy, 1 + dx), (height, width))
        valid = jax.lax.dynamic_slice(vmask, (1 + dy, 1 + dx), (height, width))
        color = _tiled_colors(cfa_name, i, height, width)
        present = set(np.unique(lut[:, :, i]))
        for c in range(4):
            if c not in present:
                continue
            sel = jnp.where(color == c, valid, 0.0)
            sums[c] = sums[c] + val * sel
            counts[c] = counts[c] + sel
    planes = [jnp.where(counts[c] > 0.0, sums[c] / counts[c], 0.0) for c in range(4)]
    if not stacked:
        return planes
    return jnp.stack(planes, axis=-1)


@partial(jax.jit, static_argnames=("cfa_name", "height", "width"))
def _demosaic_impl(plane, *, cfa_name, height, width):
    return stencil_demosaic(plane, cfa_name, height, width)


@partial(jax.jit, static_argnames=("cfa_name", "height", "width"))
def _demosaic_impl_planar(plane, *, cfa_name, height, width):
    return jnp.stack(stencil_demosaic(plane, cfa_name, height, width,
                                      stacked=False), axis=0)


def demosaic_full(cfa: CFA, buf: OpBuffer) -> OpBuffer:
    """CFA single-plane -> 4-channel RGBE at full resolution (planar)."""
    data = _demosaic_impl_planar(buf.data[0], cfa_name=cfa.name,
                                 height=buf.height, width=buf.width)
    return OpBuffer(buf.width, buf.height, 4, buf.monochrome, data)
