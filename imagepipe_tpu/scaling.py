"""Geometry engine: size planning (host) and the windowed resampler (device).

Re-design of /root/reference/src/scaling.rs. The reference walks each
destination pixel's source window in scalar Rust with rayon rows; here the
same math runs as a vectorized gather loop on the device: all destination pixels
advance through their windows in lockstep (one [nh, nw] gather per window
offset, `lax.fori_loop` over the statically-bounded window size), which keeps
shapes static for XLA while reproducing the reference's exact weighting
(paraboloid low-pass, scaling.rs:104-107) and f32 index arithmetic.

Host-side size planning (calculate_scaling_total, scaling.rs:8-32) replicates
the reference's f32 divisions and truncations so planned sizes agree exactly.
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .buffer import OpBuffer

__all__ = [
    "calculate_scaling_total", "scaling_size", "calculate_scale",
    "transform_buffer", "scaled_demosaic", "scale_down_opbuf",
    "scale_down_srgb", "scale_down_srgb16",
]

_f32 = np.float32


def sat_floor_np(v, maxv, dtype=np.int64):
    """floor -> NaN->0 -> clip[0, maxv]: the host-side f32 two-rounding
    window-index helper (reference scaling.rs from/to semantics). Lives
    here so every consumer shares ONE definition -- the index math MUST stay in
    host numpy f32 because XLA's FMA contraction changes the rounding
    that feeds this floor (see module notes)."""
    v = np.floor(v)
    v = np.where(np.isnan(v), 0.0, v)
    return np.clip(v, 0.0, maxv).astype(dtype)


def calculate_scaling_total(width: int, height: int, maxwidth: int, maxheight: int):
    """Aspect-preserving fit that never upscales (scaling.rs:8-23). All the
    arithmetic is float32 to match the reference bit-for-bit."""
    if maxwidth == 0 and maxheight == 0:
        return (1.0, width, height)
    xscale = _f32(1.0) if maxwidth == 0 else _f32(_f32(width) / _f32(maxwidth))
    yscale = _f32(1.0) if maxheight == 0 else _f32(_f32(height) / _f32(maxheight))
    if yscale <= 1.0 and xscale <= 1.0:
        return (1.0, width, height)
    elif yscale > xscale:
        return (float(yscale), int(_f32(width) / yscale), maxheight)
    else:
        return (float(xscale), maxwidth, int(_f32(height) / xscale))


def scaling_size(width: int, height: int, maxwidth: int, maxheight: int):
    _, w, h = calculate_scaling_total(width, height, maxwidth, maxheight)
    return (w, h)


def calculate_scale(width: int, height: int, maxwidth: int, maxheight: int) -> float:
    return calculate_scaling_total(width, height, maxwidth, maxheight)[0]


# ---------------------------------------------------------------------------
# The resampler (transform_buffer, scaling.rs:51-130).
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=(
    "width", "height", "topleft", "topright", "bottomleft",
    "nwidth", "nheight", "components", "cfa_key", "out_dtype"))
def _transform_impl(src, cfa_tile, *, width, height, topleft, topright, bottomleft,
                    nwidth, nheight, components, cfa_key, out_dtype):
    """src: [height, width, C] f32 (C=1 in CFA mode). Returns
    [nheight, nwidth, components] of out_dtype.

    cfa_key is only a jit cache key for the (device-resident) cfa_tile; None
    means plain multi-channel resampling.
    """
    f = jnp.float32
    tl0, tl1 = _f32(topleft[0]), _f32(topleft[1])
    tr0, tr1 = _f32(topright[0]), _f32(topright[1])
    bl0, bl1 = _f32(bottomleft[0]), _f32(bottomleft[1])

    # Per-axis skips (scaling.rs:69-72); f32 division, inf when n == 1.
    with np.errstate(divide="ignore", invalid="ignore"):
        skip_x_x = _f32((tr0 - tl0) / _f32(nwidth - 1))
        skip_x_y = _f32((tr1 - tl1) / _f32(nwidth - 1))
        skip_y_x = _f32((bl0 - tl0) / _f32(nheight - 1))
        skip_y_y = _f32((bl1 - tl1) / _f32(nheight - 1))

    # Row-level terms (scaling.rs:77-82) and the per-column products
    # (scaling.rs:84-89) are precomputed host-side as 1-D numpy f32 arrays:
    # the reference rounds the product skip*index to f32 BEFORE adding, and
    # XLA would otherwise contract `base + skip*index` into an FMA whose
    # single rounding can floor() to a different source pixel at exact
    # integer window boundaries. With the products baked as constants the
    # device graph has a single add feeding floor -- nothing to contract.
    rows_np = np.arange(nheight, dtype=_f32)
    cols_np = np.arange(nwidth, dtype=_f32)
    with np.errstate(invalid="ignore"):
        from_x_row = jnp.asarray(tl0 + skip_y_x * rows_np)[:, None]
        to_x_row = jnp.asarray(tl0 + skip_y_x * (rows_np + _f32(1.0)))[:, None]
        from_y_row = jnp.asarray(tl1 + skip_y_y * rows_np)[:, None]
        to_y_row = jnp.asarray(tl1 + skip_y_y * (rows_np + _f32(1.0)))[:, None]
        fx_col = jnp.asarray(skip_x_x * cols_np)[None, :]
        tx_col = jnp.asarray(skip_x_x * (cols_np + _f32(1.0)))[None, :]
        fy_col = jnp.asarray(skip_x_y * cols_np)[None, :]
        ty_col = jnp.asarray(skip_x_y * (cols_np + _f32(1.0)))[None, :]
        center_x_row = jnp.asarray(tl0 + skip_y_x * rows_np + (skip_y_x / _f32(2.0)) - _f32(0.5))[:, None]
        center_y_row = jnp.asarray(tl1 + skip_y_y * rows_np + (skip_y_y / _f32(2.0)) - _f32(0.5))[:, None]
        cx_col = jnp.asarray(skip_x_x * cols_np + (skip_x_x / _f32(2.0)))[None, :]
        cy_col = jnp.asarray(skip_x_y * cols_np + (skip_x_y / _f32(2.0)))[None, :]

    def sat_idx(v, maxv):
        # Rust `value.floor() as usize` saturates negatives (and NaN) to 0,
        # then cmp::min(maxv, .) (scaling.rs:84-87).
        v = jnp.where(jnp.isnan(v), 0.0, v)
        return jnp.minimum(jnp.maximum(jnp.floor(v), 0.0), _f32(maxv)).astype(jnp.int32)

    from_x = sat_idx(from_x_row + fx_col, width - 1)       # [nh,nw]
    to_x = sat_idx(to_x_row + tx_col, width - 1)
    from_y = sat_idx(from_y_row + fy_col, height - 1)
    to_y = sat_idx(to_y_row + ty_col, height - 1)
    center_x = center_x_row + cx_col
    center_y = center_y_row + cy_col

    # Static window bound: every dest pixel's window fits in K_y x K_x.
    def bound(a, b):
        s = (0.0 if not math.isfinite(float(a)) else abs(float(a))) + (
            0.0 if not math.isfinite(float(b)) else abs(float(b)))
        return max(1, min(int(math.ceil(s)) + 2, max(width, height)))

    K_x = bound(skip_x_x, skip_y_x)
    K_y = bound(skip_x_y, skip_y_y)

    cfa_mode = cfa_key is not None
    nsum = 4 if cfa_mode else components
    sums0 = jnp.zeros((nheight, nwidth, nsum), f)
    counts0 = jnp.zeros((nheight, nwidth, nsum if cfa_mode else 1), f)

    def body(k, acc):
        sums, counts = acc
        ky = k // K_x
        kx = k % K_x
        y = from_y + ky
        x = from_x + kx
        valid = (y <= to_y) & (x <= to_x)
        yc = jnp.minimum(y, height - 1)
        xc = jnp.minimum(x, width - 1)
        # Weight = max(0, 1 - dx^2 - dy^2) (scaling.rs:104-107); the explicit
        # `where(f < 0)` preserves the reference's NaN pass-through.
        # True f32 division (not reciprocal-multiply) to match scaling.rs:104-105.
        delta_x = (x.astype(f) - center_x) / skip_x_x
        delta_y = (y.astype(f) - center_y) / skip_y_y
        factor = 1.0 - delta_x * delta_x - delta_y * delta_y
        factor = jnp.where(factor < 0.0, 0.0, factor)
        w = jnp.where(valid, factor, 0.0)

        if cfa_mode:
            val = src[yc, xc, 0]                                # [nh,nw]
            color = cfa_tile[yc % 48, xc % 48].astype(jnp.int32)  # [nh,nw]
            onehot = (color[..., None] == jnp.arange(4, dtype=jnp.int32))
            contrib = jnp.where(onehot, (val * w)[..., None], 0.0)
            wcount = jnp.where(onehot, w[..., None], 0.0)
            return sums + contrib, counts + wcount
        else:
            val = src[yc, xc, :]                                # [nh,nw,C]
            return sums + val * w[..., None], counts + w[..., None]

    sums, counts = jax.lax.fori_loop(0, K_x * K_y, body, (sums0, counts0))
    out = jnp.where(counts > 0.0, sums / counts, 0.0)
    if not cfa_mode and components != out.shape[-1]:
        out = out[..., :components]
    if out_dtype == jnp.float32:
        return out
    # Integer outputs truncate-and-saturate like Rust `as` (num-traits
    # AsPrimitive used at scaling.rs:124).
    info = jnp.iinfo(out_dtype)
    return jnp.clip(jnp.trunc(out), info.min, info.max).astype(out_dtype)


@partial(jax.jit, static_argnames=(
    "width", "height", "topleft", "topright", "bottomleft",
    "nwidth", "nheight", "components", "cfa_key", "out_dtype", "planar",
    "banded", "unroll"))
def _transform_aligned_impl(src, cfa_tile, *, width, height, topleft, topright,
                            bottomleft, nwidth, nheight, components, cfa_key,
                            out_dtype, planar=False, banded=None,
                            unroll=None):
    """Axis-aligned specialization of the resampler (no rotation: every
    scale-down and crop path). Identical per-pixel semantics to
    _transform_impl, restructured around separable axes:

      * row windows are contiguous -> per-window-row `jnp.take` row gathers;
      * column selection becomes a matmul against a single one-hot matrix
        (selection by 0/1 matmul at HIGHEST precision is exact), with
        window offsets as cheap shifts of the padded row block;
      * everything is channel-planar [C, H, W] internally, like every
        device buffer of the pipeline.

    src: [H, W, C] (planar=False) or [C, H, W] (planar=True); output layout
    matches. The fori(ky) x fori(kx) accumulation order matches the
    reference's y-outer/x-inner scalar loop (scaling.rs:93-120).
    """
    f = jnp.float32
    tl0, tl1 = _f32(topleft[0]), _f32(topleft[1])
    tr0 = _f32(topright[0])
    bl1 = _f32(bottomleft[1])
    with np.errstate(divide="ignore", invalid="ignore"):
        skip_x_x = _f32((tr0 - tl0) / _f32(nwidth - 1))
        skip_y_y = _f32((bl1 - tl1) / _f32(nheight - 1))

    rows_np = np.arange(nheight, dtype=_f32)
    cols_np = np.arange(nwidth, dtype=_f32)

    def sat_np(v, maxv):
        return sat_floor_np(v, maxv, dtype=np.int32)

    # Host-side f32 two-rounding index math (see _transform_impl notes).
    with np.errstate(invalid="ignore"):
        from_x1 = sat_np(_f32(tl0) + skip_x_x * cols_np, width - 1)        # [nw]
        to_x1 = sat_np(_f32(tl0) + skip_x_x * (cols_np + _f32(1.0)), width - 1)
        from_y1 = sat_np(_f32(tl1) + skip_y_y * rows_np, height - 1)       # [nh]
        to_y1 = sat_np(_f32(tl1) + skip_y_y * (rows_np + _f32(1.0)), height - 1)
        # Reference f32 order: ((tl0 - 0.5) + sxx*col) + sxx/2 (scaling.rs:81,88).
        center_x1 = ((tl0 - _f32(0.5)) + skip_x_x * cols_np) + (skip_x_x / _f32(2.0))
        center_y1 = (tl1 + skip_y_y * rows_np + (skip_y_y / _f32(2.0))) - _f32(0.5)

    # Exact window bounds (host-side): the largest inclusive window any
    # output pixel covers on each axis.
    K_x = max(1, int((to_x1 - from_x1).max()) + 1)
    K_y = max(1, int((to_y1 - from_y1).max()) + 1)

    src_chw = src if planar else jnp.moveaxis(jnp.atleast_3d(src), -1, 0)

    cfa_mode = cfa_key is not None
    if cfa_mode:
        # One value plane; per-color masks apply AFTER selection, computed at
        # the output coordinates from the periodic pattern (tiny mod/select
        # math) -- 8x fewer selection-matmul FLOPs than selecting per-color
        # value+mask planes.
        from .raw import CFA as _CFA

        pattern = _CFA(cfa_key).pattern  # static [ph, pw]
        ph, pw = pattern.shape
        planes = src_chw[:1]                    # [1, H, W]
        nsum = 4
    else:
        planes = src_chw                        # [C, H, W]
        nsum = components

    C = planes.shape[0]
    from_x_d = jnp.asarray(from_x1)
    to_x_d = jnp.asarray(to_x1)
    from_y_d = jnp.asarray(from_y1)
    to_y_d = jnp.asarray(to_y1)
    cx_d = jnp.asarray(center_x1.astype(_f32))
    cy_d = jnp.asarray(center_y1.astype(_f32))

    # Column selection formulation. Global: one-hot [nw, W] — every output
    # column's dot spans the full source width, so MXU work is O(W) per
    # output column regardless of the window. Banded: from_x is HOST data,
    # so 128-column output blocks get STATIC source bands; selection runs
    # block-local dots [C*nh, BAND] x [BAND, 128] — at near-full-size
    # resizes (the fulldown path: 24MP -> 0.5-0.8x) that is 20-30x fewer
    # MACs, and selection stays bit-exact (one-hot rows pick the same
    # values; added zeros are exact in f32). `banded=None` auto-selects.
    BLK = 128
    if banded is None:
        banded = nwidth > BLK
    if banded:
        nblocks = -(-nwidth // BLK)
        fx_pad = np.concatenate(
            [from_x1, np.full(nblocks * BLK - nwidth, width - 1, np.int32)])
        blocks = fx_pad.reshape(nblocks, BLK)
        band_starts = blocks.min(axis=1).astype(np.int64)
        extent = int((blocks.max(axis=1) - band_starts).max()) + 1
        BAND = min(-(-extent // 128) * 128, width)
        # Worth it only when bands are meaningfully narrower than the
        # source (the global form's single big dot schedules better when
        # BAND ~ W; 3x keeps a real margin over the per-block overheads).
        banded = BAND * 3 <= width and nblocks >= 2
    if banded:
        band_starts = np.minimum(band_starts, max(width - BAND, 0))
        local = blocks - band_starts[:, None]                # [nb, BLK]
        P_bands = jnp.asarray(
            (np.arange(BAND)[None, None, :] == local[:, :, None])
            .astype(np.float32))                             # [nb, BLK, BAND]
        pad_w = max(0, int(band_starts.max()) + BAND + K_x - width)
        band_starts = [int(s) for s in band_starts]
        P = None
    else:
        xs = jnp.arange(width, dtype=jnp.int32)
        P = (xs[None, :] == from_x_d[:, None]).astype(f)
        pad_w = K_x
    if unroll is None:
        # Static unroll makes the banded slice offsets compile-time
        # constants, so XLA fuses across window steps: on the GPU it beats
        # the fori form on the 24MP -> 0.79x fulldown (PERF.md, unroll
        # finding). Compile cost scales with K_y*K_x, so only small windows
        # unroll. Other backends keep the fori form, which the CPU parity
        # tests pin bit-for-bit.
        unroll = K_y * K_x <= 32 and jax.default_backend() == "gpu"

    nacc = nsum if cfa_mode else C
    sums0 = jnp.zeros((nacc, nheight, nwidth), f)
    counts_cfa0 = jnp.zeros((4, nheight, nwidth), f)

    def ky_body(ky, acc):
        sums, ccounts = acc
        y = jnp.minimum(from_y_d + ky, height - 1)
        valid_y = (from_y_d + ky) <= to_y_d
        dy = (y.astype(f) - cy_d) / skip_y_y
        dy2 = dy * dy                                                  # [nh]
        py = (y % ph)[:, None] if cfa_mode else None

        A = jnp.take(planes, y, axis=1)                   # [C, nh, W] row gather
        A = A.reshape(C * nheight, width)
        A_pad = jnp.pad(A, ((0, 0), (0, pad_w)))

        def kx_body(kx, acc):
            sums, ccounts = acc
            x = jnp.minimum(from_x_d + kx, width - 1)
            valid_x = (from_x_d + kx) <= to_x_d
            dx = (x.astype(f) - cx_d) / skip_x_x
            # factor = (1 - dx^2) - dy^2 in the reference's order.
            factor = (1.0 - dx * dx)[None, :] - dy2[:, None]
            factor = jnp.where(factor < 0.0, 0.0, factor)
            w = jnp.where(valid_y[:, None] & valid_x[None, :], factor, 0.0)

            # HIGHEST = full float32 products. The other operand is 0/1, so
            # each product is exact and the sum adds exact zeros: selection
            # is bit-exact. Lower precisions round the selected value (TF32
            # keeps 10 mantissa bits on the GPU), which breaks the 16-bit
            # +-1 LSB contract.
            if banded:
                sels = []
                for b, bs in enumerate(band_starts):
                    A_sh = jax.lax.dynamic_slice(
                        A_pad, (0, bs + kx), (C * nheight, BAND))
                    sels.append(jax.lax.dot_general(
                        A_sh, P_bands[b], (((1,), (1,)), ((), ())),
                        precision=jax.lax.Precision.HIGHEST))  # [C*nh, BLK]
                sel = jnp.concatenate(sels, axis=1)[:, :nwidth]
            else:
                A_shift = jax.lax.dynamic_slice(
                    A_pad, (0, kx), (C * nheight, width))
                sel = jax.lax.dot_general(
                    A_shift, P, (((1,), (1,)), ((), ())),
                    precision=jax.lax.Precision.HIGHEST)  # [C*nh, nw]
            sel = sel.reshape(C, nheight, nwidth)

            if not cfa_mode:
                return sums + sel * w[None, :, :], ccounts

            # Source-pixel color at the selected coords, from the periodic
            # pattern (flat code = (y%ph)*pw + x%pw, static where-chain).
            px = (x % pw)[None, :]
            code = py * pw + px                           # [nh, nw]
            flat = [int(v) for v in pattern.ravel()]
            color = jnp.full((nheight, nwidth), flat[0], jnp.int32)
            for idx_code in range(1, ph * pw):
                color = jnp.where(code == idx_code, flat[idx_code], color)
            sv = sel[0] * w
            new_sums = []
            new_counts = []
            for c in range(4):
                m = (color == c).astype(f)
                new_sums.append(sums[c] + sv * m)
                new_counts.append(ccounts[c] + w * m)
            return jnp.stack(new_sums, 0), jnp.stack(new_counts, 0)

        if unroll:
            # Static unroll: kx becomes a compile-time constant, so the
            # banded slice offsets are static and XLA can CSE the block
            # slices and fuse dot+weight+accumulate across the window.
            # Accumulation ORDER matches the fori form, but cross-iteration
            # fusion moves FMA placement (the documented trap), so the
            # contract vs the fori form is the cross-graph one (<=1 LSB
            # after quantize), not f32 bit-equality.
            acc = (sums, ccounts)
            for kx in range(K_x):
                acc = kx_body(kx, acc)
            return acc
        return jax.lax.fori_loop(0, K_x, kx_body, (sums, ccounts))

    if unroll:
        acc = (sums0, counts_cfa0)
        for ky in range(K_y):
            acc = ky_body(ky, acc)
        sums, counts_cfa = acc
    else:
        sums, counts_cfa = jax.lax.fori_loop(
            0, K_y, ky_body, (sums0, counts_cfa0))

    if cfa_mode:
        vals = sums
        counts = counts_cfa
    else:
        # counts are selection-independent: sum of weights.
        def count_body(k, acc):
            ky = k // K_x
            kx = k % K_x
            y = from_y_d + ky
            x = from_x_d + kx
            valid = (y <= to_y_d)[:, None] & (x <= to_x_d)[None, :]
            dy = (jnp.minimum(y, height - 1).astype(f) - cy_d) / skip_y_y
            dx = (jnp.minimum(x, width - 1).astype(f) - cx_d) / skip_x_x
            factor = (1.0 - dx * dx)[None, :] - (dy * dy)[:, None]
            factor = jnp.where(factor < 0.0, 0.0, factor)
            return acc + jnp.where(valid, factor, 0.0)

        counts = jax.lax.fori_loop(
            0, K_x * K_y, count_body, jnp.zeros((nheight, nwidth), f))[None]
        vals = sums

    out = jnp.where(counts > 0.0, vals / counts, 0.0)     # [C', nh, nw]
    if not cfa_mode and components != out.shape[0]:
        out = out[:components]
    if out_dtype != jnp.float32:
        info = jnp.iinfo(out_dtype)
        out = jnp.clip(jnp.trunc(out), info.min, info.max).astype(out_dtype)
    if planar:
        return out
    return jnp.moveaxis(out, 0, -1)


def _cfa_args(cfa):
    """(cfa_tile, cfa_key) jit args for the _transform_* impls: the device
    pattern tile plus its static cache key (None -> non-CFA mode with a
    dummy tile; the impls only read the tile when cfa_key is not None)."""
    if cfa is not None:
        return jnp.asarray(cfa.pattern_tile(), dtype=jnp.uint8), cfa.name
    return jnp.zeros((48, 48), dtype=jnp.uint8), None


def transform_buffer(src, width, height, topleft, topright, bottomleft,
                     nwidth, nheight, components, cfa=None, out_dtype=jnp.float32):
    """General inverse-mapped affine resampler (scaling.rs:51-130).

    src: [height, width, C] device array (f32; integer srgb inputs are cast
    in by the wrappers). cfa: optional CFA whose pattern makes accumulation
    color-aware (the fused demosaic-downscale path).
    """
    cfa_tile, cfa_key = _cfa_args(cfa)
    # Axis-aligned geometry (every scale-down / pure-crop path) uses the
    # one-hot selection formulation; rotation uses the gather loop.
    aligned = (int(topright[1]) == int(topleft[1])
               and int(bottomleft[0]) == int(topleft[0])
               and nwidth > 1 and nheight > 1)
    impl = _transform_aligned_impl if aligned else _transform_impl
    return impl(
        src, cfa_tile,
        width=int(width), height=int(height),
        topleft=(int(topleft[0]), int(topleft[1])),
        topright=(int(topright[0]), int(topright[1])),
        bottomleft=(int(bottomleft[0]), int(bottomleft[1])),
        nwidth=int(nwidth), nheight=int(nheight),
        components=int(components), cfa_key=cfa_key, out_dtype=out_dtype)


def scale_down_planar(src_chw, nwidth, nheight, components, cfa=None):
    """Planar ([C,H,W] in, [C',nh,nw] out) axis-aligned scale-down for the
    fused engine -- avoids HWC intermediates entirely. src_chw: [C, H, W]
    (C=1 with cfa for the fused demosaic-downscale)."""
    _, height, width = src_chw.shape
    cfa_tile, cfa_key = _cfa_args(cfa)
    return _transform_aligned_impl(
        src_chw, cfa_tile,
        width=int(width), height=int(height),
        topleft=(0, 0), topright=(int(width) - 1, 0), bottomleft=(0, int(height) - 1),
        nwidth=int(nwidth), nheight=int(nheight),
        components=int(components), cfa_key=cfa_key, out_dtype=jnp.float32,
        planar=True)


def _scale_down(src, width, height, nwidth, nheight, components, cfa=None,
                out_dtype=jnp.float32):
    return transform_buffer(
        src, width, height, (0, 0), (width - 1, 0), (0, height - 1),
        nwidth, nheight, components, cfa, out_dtype)


def transform_buffer_planar(src_chw, width, height, topleft, topright,
                            bottomleft, nwidth, nheight, components, cfa=None):
    """Planar ([C,H,W] in/out) resampler entry: aligned geometry uses the
    planar selection core directly; rotated geometry round-trips through
    the HWC gather loop."""
    aligned = (int(topright[1]) == int(topleft[1])
               and int(bottomleft[0]) == int(topleft[0])
               and nwidth > 1 and nheight > 1)
    if aligned:
        cfa_tile, cfa_key = _cfa_args(cfa)
        return _transform_aligned_impl(
            src_chw, cfa_tile,
            width=int(width), height=int(height),
            topleft=(int(topleft[0]), int(topleft[1])),
            topright=(int(topright[0]), int(topright[1])),
            bottomleft=(int(bottomleft[0]), int(bottomleft[1])),
            nwidth=int(nwidth), nheight=int(nheight),
            components=int(components), cfa_key=cfa_key,
            out_dtype=jnp.float32, planar=True)
    cfa_tile, cfa_key = _cfa_args(cfa)
    out_hwc = _transform_impl(
        jnp.moveaxis(src_chw, 0, -1), cfa_tile,
        width=int(width), height=int(height),
        topleft=(int(topleft[0]), int(topleft[1])),
        topright=(int(topright[0]), int(topright[1])),
        bottomleft=(int(bottomleft[0]), int(bottomleft[1])),
        nwidth=int(nwidth), nheight=int(nheight),
        components=int(components), cfa_key=cfa_key, out_dtype=jnp.float32)
    return jnp.moveaxis(out_hwc, -1, 0)


def scaled_demosaic(cfa, buf: OpBuffer, nwidth: int, nheight: int) -> OpBuffer:
    """Demosaic fused with downscale in one pass (scaling.rs:132-145): each
    output pixel averages the CFA-aware source window -- the key trick that
    avoids materializing full-res RGB for thumbnail renders (HBM budget)."""
    assert buf.colors == 1
    data = transform_buffer_planar(
        buf.data, buf.width, buf.height, (0, 0), (buf.width - 1, 0),
        (0, buf.height - 1), nwidth, nheight, 4, cfa)
    return OpBuffer(nwidth, nheight, 4, buf.monochrome, data)


def scale_down_opbuf(buf: OpBuffer, nwidth: int, nheight: int) -> OpBuffer:
    """Plain 4-channel downscale (scaling.rs:147-160)."""
    assert buf.colors == 4
    data = transform_buffer_planar(
        buf.data, buf.width, buf.height, (0, 0), (buf.width - 1, 0),
        (0, buf.height - 1), nwidth, nheight, 4)
    return OpBuffer(nwidth, nheight, 4, buf.monochrome, data)


def scale_down_srgb(data, nwidth: int, nheight: int):
    """u8 interleaved sRGB downscale (scaling.rs:162-171); fastpath resize."""
    h, w, _ = data.shape
    src = jnp.asarray(data).astype(jnp.float32)
    return _scale_down(src, w, h, nwidth, nheight, 3, out_dtype=jnp.uint8)


def scale_down_srgb16(data, nwidth: int, nheight: int):
    """u16 interleaved sRGB downscale (scaling.rs:173-182)."""
    h, w, _ = data.shape
    src = jnp.asarray(data).astype(jnp.float32)
    return _scale_down(src, w, h, nwidth, nheight, 3, out_dtype=jnp.uint16)
