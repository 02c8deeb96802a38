"""Fused develop engine: the whole RAW->sRGB chain as one device program.

This is the batched answer to the reference's per-stage execution
(/root/reference/src/pipeline.rs:363-372, one materialized buffer per op):
when no interactive stage cache is needed, the full chain -- levels,
demosaic, white balance + camera matrix + Lab, tone spline, Lab^-1, gamma,
quantize -- traces into a single jit so XLA fuses every elementwise stage
into the demosaic stencil's output pass. One HBM round-trip instead of
eight. The batch engine vmaps this over [B,H,W] and shards the batch axis
over the device mesh.

Numerics: the fused trace calls the same kernel functions as the staged
path; 8-bit outputs are bit-identical, 16-bit outputs may differ by 1 LSB on
a small fraction of pixels because whole-chain fusion changes a few f32
rounding points (FMA contraction across former jit boundaries) -- within the
reference's own 16-bit +-1 LSB contract (color_conversions.rs:595-596).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from . import color as cc

from .kernels.demosaic_full import stencil_demosaic_planes
from .raw import CFA
from .spline import SplineFunc

__all__ = ["DevelopPlan", "make_develop_plan", "develop_batch_fn"]


class DevelopPlan:
    """Host-side compiled plan: static config + device params for the fused
    develop of one RAW shape class."""

    def __init__(self, *, cfa_name, height, width, crop_x, crop_y, mode,
                 out_bits, linear, params, apply_curve, n_knots,
                 orientation_flips, numerics, dem_path="full",
                 dem_w=0, dem_h=0):
        self.cfa_name = cfa_name
        self.height = height
        self.width = width
        self.crop_x = crop_x
        self.crop_y = crop_y
        self.mode = mode            # 'cfa' | 'mono' | 'rgb'
        self.out_bits = out_bits    # 8 | 16
        self.linear = linear
        self.params = params        # dict of device arrays
        self.apply_curve = apply_curve
        self.n_knots = n_knots
        self.orientation_flips = orientation_flips  # (transpose, flipx, flipy)
        self.numerics = numerics    # 'lut' | 'direct'
        self.dem_path = dem_path    # 'full' | 'scaled' | 'fulldown' | 'plaindown'
        self.dem_w = dem_w
        self.dem_h = dem_h

    def statics(self):
        return dict(cfa_name=self.cfa_name, height=self.height, width=self.width,
                    crop_x=self.crop_x, crop_y=self.crop_y,
                    mode=self.mode, out_bits=self.out_bits, linear=self.linear,
                    apply_curve=self.apply_curve, n_knots=self.n_knots,
                    orientation_flips=self.orientation_flips,
                    numerics=self.numerics, dem_path=self.dem_path,
                    dem_w=self.dem_w, dem_h=self.dem_h)


def make_develop_plan(pipeline, out_bits: int = 8, numerics: str = "auto") -> DevelopPlan:
    """Build the fused plan from a Pipeline over a RAW source with default
    geometry (no rotatecrop, full-size demosaic)."""
    from .ops.colorspaces import normalize_wbs

    img = pipeline.globals.image
    assert img.is_raw, "fused plan targets the RAW path"
    raw = img.raw
    ops = pipeline.ops
    assert ops.rotatecrop._noop(), "fused plan does not cover rotatecrop"

    gf = ops.gofloat
    x, y, width, height = gf._size_image(raw.width, raw.height)

    if raw.cpp == 3:
        mode = "rgb"
    elif gf.is_cfa:
        mode = "cfa"
    else:
        mode = "mono"

    monochrome = mode == "mono"
    if monochrome:
        cmatrix = cc.SRGB_D65_43
        mul = [1.0, 1.0, 1.0, 1.0]
    else:
        cmatrix = ops.tolab.cam_to_xyz_normalized
        mul = normalize_wbs(ops.tolab.wb_coeffs)

    bc = ops.basecurve
    apply_curve = not (len(bc.points) == 0 and abs(bc.exposure) < 0.001)
    n_knots = 0
    if apply_curve:
        scale = 2.0 ** bc.exposure
        spline = SplineFunc([(px, py * scale) for (px, py) in bc.points])
        n_knots = len(spline.xs)
        spl = dict(
            spline_xs=jnp.asarray(spline.xs), spline_ys=jnp.asarray(spline.ys),
            spline_c1=jnp.asarray(spline.c1s), spline_c2=jnp.asarray(spline.c2s),
            spline_c3=jnp.asarray(spline.c3s))
    else:
        spl = {}

    cfa = CFA(ops.demosaic.cfa) if mode == "cfa" else None
    params = dict(
        mins=jnp.asarray(gf.blacklevels, jnp.float32),
        ranges=jnp.asarray([w - b for w, b in zip(gf.whitelevels, gf.blacklevels)],
                           jnp.float32),
        mul=jnp.asarray(mul, jnp.float32),
        cmatrix=jnp.asarray(cmatrix, jnp.float32),
        rgbmatrix=jnp.asarray(cc.XYZ_D65_33),
        **spl,
    )
    # Demosaic-stage target size via the reference's 3-pass size planning
    # (pipeline.rs:317-338); picks the same path demosaic.rs:41-60 would.
    settings = pipeline.globals.settings
    dem_path, dem_w, dem_h = "full", width, height
    if settings.maxwidth or settings.maxheight:
        from . import scaling as _scaling

        allops = pipeline.ops.all_ops()
        for op in allops:
            op.reset()
        fw, fh = pipeline.globals.image.width(), pipeline.globals.image.height()
        for op in allops:
            fw, fh = op.transform_forward(fw, fh)
        fw, fh = _scaling.scaling_size(fw, fh, settings.maxwidth, settings.maxheight)
        for op in reversed(allops):
            fw, fh = op.transform_reverse(fw, fh)
        for op in allops:
            op.reset()
        dem_w, dem_h = fw, fh
        scale = _scaling.calculate_scale(width, height, dem_w, dem_h)
        if mode != "cfa":
            dem_path = "plaindown" if scale > 1.0 else "full"
        else:
            from .ops.demosaic import minscale_for

            minscale = minscale_for(cfa.width if cfa is not None else 2)
            if scale <= 1.0:
                dem_path = "full"
            elif scale >= minscale:
                dem_path = "scaled"
            else:
                dem_path = "fulldown"

    if numerics == "auto":
        numerics = cc.default_numerics()
    return DevelopPlan(
        cfa_name=(cfa.name if cfa is not None else ""),
        height=height, width=width, crop_x=x, crop_y=y, mode=mode, out_bits=out_bits,
        linear=pipeline.globals.settings.linear and out_bits == 16,
        params=params, apply_curve=apply_curve, n_knots=n_knots,
        orientation_flips=ops.transform._orientation().to_flips(),
        numerics=numerics, dem_path=dem_path, dem_w=dem_w, dem_h=dem_h,
    )




def _spline_eval(params, n_knots, v):
    from .spline import eval_spline_arrays

    return eval_spline_arrays(
        params["spline_xs"], params["spline_ys"], params["spline_c1"],
        params["spline_c2"], params["spline_c3"], n_knots, v)


def _develop_one(plane, params, *, cfa_name, height, width, crop_x, crop_y,
                 mode, out_bits, linear, apply_curve, n_knots,
                 orientation_flips, numerics, dem_path="full", dem_w=0,
                 dem_h=0):
    """plane: full sensor [H0,W0] (cfa/mono) or [H0,W0,3] (rgb) raw counts ->
    developed [3, H', W'] quantized (channel-planar, like every device
    buffer of the pipeline). Sensor crop applied here (static). Host side
    converts to HWC."""
    f = jnp.float32
    plane = plane.astype(f)
    if plane.ndim == 2:
        plane = jax.lax.slice(plane, (crop_y, crop_x),
                              (crop_y + height, crop_x + width))
    else:
        plane = jax.lax.slice(plane, (crop_y, crop_x, 0),
                              (crop_y + height, crop_x + width, 3))

    from . import scaling as _scaling
    from .raw import CFA as _CFA

    # gofloat (levels; cfa/mono paths use channel-0 levels, gofloat.rs:101-127)
    if mode == "rgb":
        rgbe = [jnp.minimum((plane[..., c] - params["mins"][c]) / params["ranges"][c], 1.0)
                for c in range(3)]
        rgbe.append(jnp.zeros((height, width), f))
    else:
        v = jnp.minimum((plane - params["mins"][0]) / params["ranges"][0], 1.0)
        if mode == "mono":
            rgbe = [v, v, v, jnp.zeros_like(v)]
        else:
            if dem_path == "scaled":
                # Fused demosaic+downscale (demosaic.rs:47-50).
                out = _scaling.scale_down_planar(v[None], dem_w, dem_h, 4,
                                                 cfa=_CFA(cfa_name))
                rgbe = [out[c] for c in range(4)]
            else:
                rgbe = stencil_demosaic_planes(v, cfa_name, height, width)
                if dem_path == "fulldown":
                    out = _scaling.scale_down_planar(jnp.stack(rgbe, 0), dem_w, dem_h, 4)
                    rgbe = [out[c] for c in range(4)]

    # Any resize path for non-CFA inputs (demosaic.rs:44-46).
    if dem_path == "plaindown":
        out = _scaling.scale_down_planar(jnp.stack(rgbe, 0), dem_w, dem_h, 4)
        rgbe = [out[c] for c in range(4)]

    return finish_planes(rgbe, params, out_bits=out_bits, linear=linear,
                         apply_curve=apply_curve, n_knots=n_knots,
                         orientation_flips=orientation_flips)


def finish_planes(rgbe, params, *, out_bits, linear, apply_curve, n_knots,
                  orientation_flips):
    """The develop back end on RGBE planes: WB/matrix/Lab/spline/Lab^-1/
    gamma/orientation/quantize -> quantized planar [3, H', W']. Shared by
    the XLA engine and the separable two-level scaled path so every device
    route computes identical transcendental forms (the <=1 LSB cross-path
    contract; see color.py module notes)."""
    # to_lab: WB + camera matrix + Lab encode
    L, A, B = cc.camera_to_lab_planar(params["mul"], params["cmatrix"], rgbe)

    # basecurve on L
    if apply_curve:
        L = _spline_eval(params, n_knots, L)

    # from_lab
    rgb = list(cc.lab_to_rgb_planar(params["rgbmatrix"], (L, A, B)))

    # gamma (skipped for 16-bit linear output, gamma.rs:17-18)
    if not linear:
        rgb = [cc.apply_srgb_gamma(jnp.clip(ch, 0.0, 1.0)) for ch in rgb]

    # quantize on device, planar [3, H', W']
    q = cc.output8bit if out_bits == 8 else cc.output16bit
    out = jnp.stack([q(ch) for ch in rgb], axis=0)

    # output transform (EXIF orientation): a pure permutation of the
    # quantized planes, behind a barrier so a transpose cannot change how
    # XLA fuses (and rounds) the arithmetic that feeds it.
    transpose, flip_x, flip_y = orientation_flips
    if not (transpose or flip_x or flip_y):
        return out
    out = jax.lax.optimization_barrier(out)
    if flip_x:
        out = out[:, :, ::-1]
    if flip_y:
        out = out[:, ::-1, :]
    if transpose:
        out = out.transpose(0, 2, 1)
    return out


def planar_to_hwc(out) -> np.ndarray:
    """Host-side [.., 3, H, W] -> [.., H, W, 3] numpy conversion."""
    return np.moveaxis(np.asarray(out), -3, -1)


_STATIC_NAMES = ("cfa_name", "height", "width", "crop_x", "crop_y", "mode",
                 "out_bits", "linear", "apply_curve", "n_knots",
                 "orientation_flips", "numerics", "dem_path", "dem_w", "dem_h")


def _statics_kw(cfa_name, height, width, crop_x, crop_y, mode, out_bits,
                linear, apply_curve, n_knots, orientation_flips, numerics,
                dem_path, dem_w, dem_h):
    return dict(cfa_name=cfa_name, height=height, width=width, crop_x=crop_x,
                crop_y=crop_y, mode=mode, out_bits=out_bits, linear=linear,
                apply_curve=apply_curve, n_knots=n_knots,
                orientation_flips=orientation_flips, numerics=numerics,
                dem_path=dem_path, dem_w=dem_w, dem_h=dem_h)


# NOTE: static_argnames only binds to explicitly named parameters; a
# **kwargs catch-all silently turns them into traced values.
@partial(jax.jit, static_argnames=_STATIC_NAMES)
def _develop_single_jit(plane, params, *, cfa_name, height, width, crop_x,
                        crop_y, mode, out_bits, linear, apply_curve, n_knots,
                        orientation_flips, numerics, dem_path="full", dem_w=0,
                        dem_h=0):
    kw = _statics_kw(cfa_name, height, width, crop_x, crop_y, mode, out_bits,
                     linear, apply_curve, n_knots, orientation_flips,
                     numerics, dem_path, dem_w, dem_h)
    with cc.numerics_mode(numerics):
        return _develop_one(plane, params, **kw)


@partial(jax.jit, static_argnames=_STATIC_NAMES)
def _develop_batch_jit(planes, params, *, cfa_name, height, width, crop_x,
                       crop_y, mode, out_bits, linear, apply_curve, n_knots,
                       orientation_flips, numerics, dem_path="full", dem_w=0,
                       dem_h=0):
    kw = _statics_kw(cfa_name, height, width, crop_x, crop_y, mode, out_bits,
                     linear, apply_curve, n_knots, orientation_flips,
                     numerics, dem_path, dem_w, dem_h)
    with cc.numerics_mode(numerics):
        return jax.vmap(lambda p: _develop_one(p, params, **kw))(planes)


@partial(jax.jit, static_argnames=_STATIC_NAMES)
def _develop_batch_perimage_jit(planes, batched_params, *, cfa_name, height,
                                width, crop_x, crop_y, mode, out_bits, linear,
                                apply_curve, n_knots, orientation_flips,
                                numerics, dem_path="full", dem_w=0, dem_h=0):
    """Batched develop with PER-IMAGE calibration: every leaf of
    batched_params carries a leading batch dim (WB multipliers, levels,
    camera matrix, spline coefficients differ per shot)."""
    kw = _statics_kw(cfa_name, height, width, crop_x, crop_y, mode, out_bits,
                     linear, apply_curve, n_knots, orientation_flips,
                     numerics, dem_path, dem_w, dem_h)
    with cc.numerics_mode(numerics):
        return jax.vmap(lambda p, prm: _develop_one(p, prm, **kw))(
            planes, batched_params)


def stack_params(param_dicts):
    """Stack a list of per-image param dicts into one batched pytree."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *param_dicts)


def normalize_plane(plan: DevelopPlan, plane):
    """Reshape a flat [H, W*3] cpp=3 sensor payload to [H, W, 3] (the layout
    RawImage permits); cfa/mono planes pass through."""
    plane = jnp.asarray(plane)
    if plan.mode == "rgb" and plane.ndim == 2:
        return plane.reshape(plane.shape[0], -1, 3)
    return plane


def normalize_plane_np(plan: DevelopPlan, plane) -> np.ndarray:
    """normalize_plane staying on the HOST: feeds that assemble global
    arrays themselves (batch, multihost) must not bounce every plane
    through the device (an upload+fetch per image)."""
    plane = np.asarray(plane)
    if plan.mode == "rgb" and plane.ndim == 2:
        return plane.reshape(plane.shape[0], -1, 3)
    return plane


# Device bytes the unbanded full-size develop holds per sensor pixel at its
# peak (f32 intermediates of the fused chain), and the share of the device's
# memory limit one develop may take. See PERF.md (61MP bring-up finding).
DEVELOP_BYTES_PER_PX = 48
DEVELOP_MEMORY_SHARE = 0.5


def auto_bands(plan: DevelopPlan, device=None) -> int:
    """Bands develop_fused uses when none are given: 1 whenever the frame's
    estimated working set fits DEVELOP_MEMORY_SHARE of the device's own
    memory_stats()["bytes_limit"], else as many as bring each band under
    it. A device that reports no limit (the CPU) develops unbanded."""
    device = device if device is not None else jax.devices()[0]
    limit = (device.memory_stats() or {}).get("bytes_limit")
    if not limit:
        return 1
    need = plan.height * plan.width * DEVELOP_BYTES_PER_PX
    return max(1, -(-need // int(limit * DEVELOP_MEMORY_SHARE)))


def develop_fused(plan: DevelopPlan, plane, bands: int | None = None):
    """Develop one image through the fused chain. plane: device or numpy
    array of raw counts.

    bands: split the image into horizontal bands with 1-row halos to bound
    peak device memory (the fused chain holds several [H,W] f32
    intermediates). Bit-identical to unbanded: the demosaic stencil is
    3x3-local and every other stage is pointwise, and the orientation
    permutation commutes with quantization so it applies after
    concatenation. None = auto_bands(plan).
    """
    plane = normalize_plane(plan, plane)
    if bands is None:
        bands = auto_bands(plan)
    if bands <= 1 or plan.mode != "cfa" or plan.dem_path != "full":
        return _develop_single_jit(plane, plan.params, **plan.statics())

    statics = plan.statics()
    h = plan.height
    band_h = -(-h // bands)
    flips = statics["orientation_flips"]
    pieces = []
    for b in range(bands):
        s = b * band_h
        e = min(h, s + band_h)
        if s >= e:
            break
        # Halo rows (clamped at image edges). Interior halos are real data,
        # so the stencil's edge handling only engages at true image edges.
        s_h = max(0, s - 1)
        e_h = min(h, e + 1)
        # The stencil's neighbor-color map is phase-0 at the slice origin;
        # re-anchor the CFA pattern to the band's first row.
        band_cfa = CFA(plan.cfa_name).shift(0, s_h).name
        band_statics = dict(statics,
                            height=e_h - s_h,
                            crop_y=statics["crop_y"] + s_h,
                            cfa_name=band_cfa,
                            orientation_flips=(False, False, False))
        out = _develop_single_jit(plane, plan.params, **band_statics)
        pieces.append(out[:, s - s_h: (s - s_h) + (e - s)])
    full = jnp.concatenate(pieces, axis=1)   # planar [3, H, W]
    transpose, flip_x, flip_y = flips
    if flip_x:
        full = full[:, :, ::-1]
    if flip_y:
        full = full[:, ::-1, :]
    if transpose:
        full = full.transpose(0, 2, 1)
    return full


def develop_batch_fn(plan: DevelopPlan):
    """Returns fn(planes [B,H,W]) -> [B,H',W',3] for batched develop; vmapped
    fused chain, jitted per (B,H,W) shape class."""
    statics = plan.statics()
    params = plan.params

    def fn(planes):
        planes = jnp.asarray(planes)
        if statics["mode"] == "rgb" and planes.ndim == 3:
            planes = planes.reshape(planes.shape[0], planes.shape[1], -1, 3)
        return _develop_batch_jit(planes, params, **statics)

    return fn
