"""Color math core: matrices, LUT-accelerated transforms, quantizers.

Vectorized re-design of the reference color layer
(/root/reference/src/color_conversions.rs:1-330). The reference evaluates a
scalar LUT-with-lerp per pixel on the CPU; here every transform is a
vectorized JAX function over whole image tensors so XLA can fuse the full
pipeline chain into a handful of HBM passes.

Numeric contract (see SURVEY.md section 4 and color_conversions.rs tests):
  * 8-bit RGB -> Lab -> RGB round trips bit-exactly,
  * 16-bit gamma+Lab round trips within +-1 LSB,
  * quantizer asymmetry: output8bit floors v*256, output16bit rounds
    half-away-from-zero (color_conversions.rs:323-330).

Two numerics modes are provided:
  * "lut"    -- reproduces the reference's 2^13-entry linearly-interpolated
                lookup table (color_conversions.rs:80-141) as a vectorized
                gather. This is the compatibility mode.
  * "direct" -- evaluates the underlying function directly (cbrt / powf).
                Fewer memory ops, no gathers; stays within the same +-1 LSB
                contract because the LUT itself is within ~4e-6 of the exact
                function.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
    "SRGB_D65_33", "SRGB_D65_XYZ_WHITE", "XYZ_D65_33", "XYZ_D65_34",
    "SRGB_D65_43", "expand_srgb_gamma", "apply_srgb_gamma", "xyz_to_lab",
    "lab_to_xyz", "camera_to_lab", "lab_to_rgb", "temp_tint_to_rgb",
    "input8bit", "input16bit", "output8bit", "output16bit",
    "set_numerics_mode", "get_numerics_mode", "numerics_mode",
]

_f32 = np.float32


def _inverse33(m: np.ndarray) -> np.ndarray:
    """3x3 inverse by adjugate in float32, mirroring the runtime inversion
    in the reference (color_conversions.rs:20-39) so the derived XYZ->RGB
    matrix is bit-identical."""
    m = m.astype(_f32)
    invdet = _f32(1.0) / (
        m[0, 0] * (m[1, 1] * m[2, 2] - m[2, 1] * m[1, 2])
        - m[0, 1] * (m[1, 0] * m[2, 2] - m[1, 2] * m[2, 0])
        + m[0, 2] * (m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0])
    )
    out = np.zeros((3, 3), dtype=_f32)
    out[0, 0] = (m[1, 1] * m[2, 2] - m[2, 1] * m[1, 2]) * invdet
    out[0, 1] = -(m[0, 1] * m[2, 2] - m[0, 2] * m[2, 1]) * invdet
    out[0, 2] = (m[0, 1] * m[1, 2] - m[0, 2] * m[1, 1]) * invdet
    out[1, 0] = -(m[1, 0] * m[2, 2] - m[1, 2] * m[2, 0]) * invdet
    out[1, 1] = (m[0, 0] * m[2, 2] - m[0, 2] * m[2, 0]) * invdet
    out[1, 2] = -(m[0, 0] * m[1, 2] - m[1, 0] * m[0, 2]) * invdet
    out[2, 0] = (m[1, 0] * m[2, 1] - m[2, 0] * m[1, 1]) * invdet
    out[2, 1] = -(m[0, 0] * m[2, 1] - m[2, 0] * m[0, 1]) * invdet
    out[2, 2] = (m[0, 0] * m[1, 1] - m[1, 0] * m[0, 1]) * invdet
    return out


# Constant matrices (color_conversions.rs:1-17).
SRGB_D65_33 = np.array(
    [
        [0.4124564, 0.3575761, 0.1804375],
        [0.2126729, 0.7151522, 0.0721750],
        [0.0193339, 0.1191920, 0.9503041],
    ],
    dtype=_f32,
)
SRGB_D65_XYZ_WHITE = (_f32(0.95047), _f32(1.000), _f32(1.08883))
XYZ_D65_33 = _inverse33(SRGB_D65_33)
XYZ_D65_34 = np.concatenate([XYZ_D65_33, np.zeros((1, 3), dtype=_f32)], axis=0)
SRGB_D65_43 = np.concatenate([SRGB_D65_33, np.zeros((3, 1), dtype=_f32)], axis=1)

# CIE Lab constants (color_conversions.rs:121-123, 181-182).
_LAB_E = _f32(_f32(216.0) / _f32(24389.0))
_LAB_K = _f32(_f32(24389.0) / _f32(27.0))

_MAXBITS = 13
_LUT_MAX = (1 << _MAXBITS) - 1  # 8191


# ---------------------------------------------------------------------------
# Numerics mode switch ("lut" = reference-faithful, "direct" = transcendentals).
# ---------------------------------------------------------------------------

# None = resolved on first use by default_numerics(). The staged ops and
# the fused engine resolve through the same function, so both device paths
# compute identical forms.
_NUMERICS_MODE = None

# The GPU default, settled by a 24MP A/B of both modes on the card (PERF.md,
# numerics finding). Other backends keep 'lut', the reference-faithful mode
# the golden-parity tests pin.
GPU_NUMERICS = "direct"


def default_numerics() -> str:
    """The numerics mode for the current default backend."""
    import jax

    return GPU_NUMERICS if jax.default_backend() == "gpu" else "lut"


def set_numerics_mode(mode: str) -> None:
    global _NUMERICS_MODE
    if mode not in ("lut", "direct"):
        raise ValueError(f"unknown numerics mode {mode!r}")
    _NUMERICS_MODE = mode


def get_numerics_mode() -> str:
    global _NUMERICS_MODE
    if _NUMERICS_MODE is None:
        _NUMERICS_MODE = default_numerics()
    return _NUMERICS_MODE


class numerics_mode:
    """Context manager setting the numerics mode during a jit trace. Any jit
    switching modes must carry the mode in its static args so traces are
    cached separately."""

    def __init__(self, mode: str):
        self.mode = mode

    def __enter__(self):
        self._prev = get_numerics_mode()  # resolve: never restore None
        set_numerics_mode(self.mode)
        return self

    def __exit__(self, *exc):
        set_numerics_mode(self._prev)
        return False


# ---------------------------------------------------------------------------
# LUT-with-lerp transform (vectorized port of TransformLookup,
# color_conversions.rs:80-115).
# ---------------------------------------------------------------------------


class TransformLUT:
    """A [0,1]->f32 transform backed by an 8193-entry table with linear
    interpolation inside [0,1] and the exact function outside.

    Table generation mirrors TransformLookup::new (color_conversions.rs:87-100):
    entry i holds transform(i / 8191) for i in 0..=8192, computed in float32.
    """

    def __init__(self, np_transform, jnp_transform, jnp_reference=None):
        idx = np.arange(_LUT_MAX + 2, dtype=np.int64)
        v = idx.astype(_f32) / _f32(_LUT_MAX)
        self.table_np = np_transform(v).astype(_f32)
        self.table = jnp.asarray(self.table_np)
        self._exact = jnp_transform
        # lut mode's out-of-range fallback must keep the reference's own
        # function forms (cbrt/powf); jnp_transform may be an accelerator-
        # tuned exp/log rewrite that only direct mode should see.
        self._reference = jnp_reference if jnp_reference is not None else jnp_transform

    def __call__(self, val):
        val = jnp.asarray(val, dtype=jnp.float32)
        if get_numerics_mode() == "direct":
            return self._exact(val)
        # lookup() (color_conversions.rs:102-114): pos = val*8191,
        # key = trunc(pos), lerp table[key]..table[key+1]; exact outside [0,1].
        pos = val * jnp.float32(_LUT_MAX)
        base = jnp.trunc(pos)
        key = jnp.clip(base.astype(jnp.int32), 0, _LUT_MAX)
        a = pos - base
        v1 = jnp.take(self.table, key)
        v2 = jnp.take(self.table, key + 1)
        lerp = v1 + a * (v2 - v1)
        in_range = (val >= 0.0) & (val <= 1.0)
        return jnp.where(in_range, lerp, self._reference(val))


def _np_xyz_lab_f(v):
    v = v.astype(_f32)
    cb = np.cbrt(v).astype(_f32)
    lin = ((_LAB_K * v + _f32(16.0)) / _f32(116.0)).astype(_f32)
    return np.where(v > _LAB_E, cb, lin)


def _jnp_xyz_lab_f_ref(v):
    """Reference-form (cbrt) for lut mode's out-of-range fallback."""
    return jnp.where(v > _LAB_E, jnp.cbrt(v), (_LAB_K * v + 16.0) / 116.0)


def _jnp_xyz_lab_f(v):
    # exp(log(v)/3) rather than jnp.cbrt: one form shared by every
    # direct-mode path (fused engine, staged ops), so they agree at the ULP
    # level -- backends lower cbrt to different polynomials, and the
    # Lab-inverse cancellation amplifies such a mismatch to >10 LSB at
    # 16-bit output.
    cb = jnp.exp(jnp.log(jnp.maximum(v, 1e-30)) * (1.0 / 3.0))
    return jnp.where(v > _LAB_E, cb, (_LAB_K * v + 16.0) / 116.0)


def _np_srgb_expand(v):
    v = v.astype(_f32)
    lo = (v / _f32(12.92)).astype(_f32)
    hi = np.power((v + _f32(0.055)) / _f32(1.055), _f32(2.4)).astype(_f32)
    return np.where(v < _f32(0.04045), lo, hi)


def _jnp_srgb_expand_ref(v):
    safe = jnp.maximum(v, jnp.float32(-0.054))
    hi = jnp.power((safe + 0.055) / 1.055, jnp.float32(2.4))
    return jnp.where(v < 0.04045, v / 12.92, hi)


def _jnp_srgb_expand(v):
    # Guard against non-positive bases (matches Rust powf domain: the
    # branch only selects hi for v >= 0.04045 anyway); exp/log form for
    # cross-path ULP agreement (see _jnp_xyz_lab_f).
    safe = jnp.maximum(v, jnp.float32(-0.054))
    hi = jnp.exp(jnp.log(jnp.maximum((safe + 0.055) / 1.055, 1e-30))
                 * jnp.float32(2.4))
    return jnp.where(v < 0.04045, v / 12.92, hi)


def _np_srgb_apply(v):
    v = v.astype(_f32)
    lo = (v * _f32(12.92)).astype(_f32)
    hi = (_f32(1.055) * np.power(np.maximum(v, _f32(0.0)), _f32(1.0) / _f32(2.4)) - _f32(0.055)).astype(_f32)
    return np.where(v < _f32(0.0031308), lo, hi)


def _jnp_srgb_apply_ref(v):
    hi = 1.055 * jnp.power(jnp.maximum(v, 0.0),
                           jnp.float32(1.0) / jnp.float32(2.4)) - 0.055
    return jnp.where(v < 0.0031308, v * 12.92, hi)


def _jnp_srgb_apply(v):
    # exp/log form, for the same cross-path reason as _jnp_xyz_lab_f.
    hi = 1.055 * jnp.exp(jnp.log(jnp.maximum(v, 1e-30))
                         * (1.0 / 2.4)) - 0.055
    return jnp.where(v < 0.0031308, v * 12.92, hi)


# The three lazy-static LUTs (color_conversions.rs:119-141).
XYZ_LAB_TRANSFORM = TransformLUT(_np_xyz_lab_f, _jnp_xyz_lab_f,
                                 _jnp_xyz_lab_f_ref)
SRGB_GAMMA_REVERSE = TransformLUT(_np_srgb_expand, _jnp_srgb_expand,
                                  _jnp_srgb_expand_ref)
SRGB_GAMMA_TRANSFORM = TransformLUT(_np_srgb_apply, _jnp_srgb_apply,
                                    _jnp_srgb_apply_ref)


def expand_srgb_gamma(v):
    """Remove sRGB gamma (color_conversions.rs:144-147)."""
    return SRGB_GAMMA_REVERSE(v)


def apply_srgb_gamma(v):
    """Apply sRGB gamma (color_conversions.rs:149-153)."""
    return SRGB_GAMMA_TRANSFORM(v)


# ---------------------------------------------------------------------------
# XYZ <-> Lab (color_conversions.rs:155-191). Lab components are re-ranged
# into [0,1]: L/100, (a+127)/255, (b+127)/255.
# ---------------------------------------------------------------------------


def xyz_to_lab(x, y, z):
    xw, yw, zw = SRGB_D65_XYZ_WHITE
    fx = XYZ_LAB_TRANSFORM(x / xw)
    fy = XYZ_LAB_TRANSFORM(y / yw)
    fz = XYZ_LAB_TRANSFORM(z / zw)
    l = 116.0 * fy - 16.0
    a = 500.0 * (fx - fy)
    b = 200.0 * (fy - fz)
    return l / 100.0, (a + 127.0) / 255.0, (b + 127.0) / 255.0


def lab_to_xyz(l, a, b):
    cl = l * 100.0
    ca = (a * 255.0) - 127.0
    cb = (b * 255.0) - 127.0

    fy = (cl + 16.0) / 116.0
    fx = ca / 500.0 + fy
    fz = fy - (cb / 200.0)

    fx3 = fx * fx * fx
    xr = jnp.where(fx3 > _LAB_E, fx3, (116.0 * fx - 16.0) / _LAB_K)
    yr = jnp.where(cl > _LAB_K * _LAB_E, fy * fy * fy, cl / _LAB_K)
    fz3 = fz * fz * fz
    zr = jnp.where(fz3 > _LAB_E, fz3, (116.0 * fz - 16.0) / _LAB_K)

    xw, yw, zw = SRGB_D65_XYZ_WHITE
    return xr * xw, yr * yw, zr * zw


# ---------------------------------------------------------------------------
# Camera RGBE -> Lab and Lab -> linear RGB (color_conversions.rs:41-65),
# vectorized over [..., 4] / [..., 3] pixel tensors.
# ---------------------------------------------------------------------------


def camera_to_lab(mul, cmatrix, pix):
    """WB-multiply (clipped to 1.0), 3x4 camera matrix, then XYZ->Lab.

    mul: [4] multipliers; cmatrix: [3][4]; pix: [..., 4] -> [..., 3].
    """
    mul = jnp.asarray(mul, dtype=jnp.float32)
    m = jnp.asarray(cmatrix, dtype=jnp.float32)
    wb = jnp.minimum(pix * mul, 1.0)
    # Match the reference's left-to-right accumulation order exactly
    # (color_conversions.rs:50-52): ((r*m0 + g*m1) + b*m2) + e*m3.
    x = ((wb[..., 0] * m[0, 0] + wb[..., 1] * m[0, 1]) + wb[..., 2] * m[0, 2]) + wb[..., 3] * m[0, 3]
    y = ((wb[..., 0] * m[1, 0] + wb[..., 1] * m[1, 1]) + wb[..., 2] * m[1, 2]) + wb[..., 3] * m[1, 3]
    z = ((wb[..., 0] * m[2, 0] + wb[..., 1] * m[2, 1]) + wb[..., 2] * m[2, 2]) + wb[..., 3] * m[2, 3]
    l, a, b = xyz_to_lab(x, y, z)
    return jnp.stack([l, a, b], axis=-1)


def lab_to_rgb(rgbmatrix, pix):
    """Lab -> XYZ -> linear RGB (color_conversions.rs:58-65).

    rgbmatrix: [3][3]; pix: [..., 3] -> [..., 3].
    """
    r, g, b = lab_to_rgb_planar(rgbmatrix, (pix[..., 0], pix[..., 1], pix[..., 2]))
    return jnp.stack([r, g, b], axis=-1)


def camera_to_lab_planar(mul, cmatrix, planes):
    """Planar camera_to_lab: planes = (r, g, b, e) arrays -> (L, a, b).

    The planar forms keep every intermediate at its natural [H, W] shape,
    so each channel is a contiguous plane for the elementwise fusions.
    """
    mul = jnp.asarray(mul, dtype=jnp.float32)
    m = jnp.asarray(cmatrix, dtype=jnp.float32)
    wb = [jnp.minimum(planes[c] * mul[c], 1.0) for c in range(4)]
    x = ((wb[0] * m[0, 0] + wb[1] * m[0, 1]) + wb[2] * m[0, 2]) + wb[3] * m[0, 3]
    y = ((wb[0] * m[1, 0] + wb[1] * m[1, 1]) + wb[2] * m[1, 2]) + wb[3] * m[1, 3]
    z = ((wb[0] * m[2, 0] + wb[1] * m[2, 1]) + wb[2] * m[2, 2]) + wb[3] * m[2, 3]
    return xyz_to_lab(x, y, z)


def lab_to_rgb_planar(rgbmatrix, lab_planes):
    """Planar lab_to_rgb: (L, a, b) -> (r, g, b)."""
    m = jnp.asarray(rgbmatrix, dtype=jnp.float32)
    x, y, z = lab_to_xyz(lab_planes[0], lab_planes[1], lab_planes[2])
    r = (x * m[0, 0] + y * m[0, 1]) + z * m[0, 2]
    g = (x * m[1, 0] + y * m[1, 1]) + z * m[1, 2]
    b = (x * m[2, 0] + y * m[2, 1]) + z * m[2, 2]
    return r, g, b


def temp_tint_to_rgb(temp: float, tint: float):
    """Host-side CCT preview color (color_conversions.rs:67-77)."""
    from .cct import temp_to_xyz

    xyz = temp_to_xyz(temp)
    x, y, z = xyz[0], xyz[1] / tint, xyz[2]
    m = XYZ_D65_33
    r = x * m[0, 0] + y * m[0, 1] + z * m[0, 2]
    g = x * m[1, 0] + y * m[1, 1] + z * m[1, 2]
    b = x * m[2, 0] + y * m[2, 1] + z * m[2, 2]
    return float(r), float(g), float(b)


# ---------------------------------------------------------------------------
# Quantizers (color_conversions.rs:312-330). Note the asymmetry:
# output8bit truncates v*256, output16bit rounds half-away-from-zero.
# ---------------------------------------------------------------------------


def input8bit(v):
    return jnp.asarray(v, dtype=jnp.float32) / 255.0


def input16bit(v):
    return jnp.asarray(v, dtype=jnp.float32) / 65535.0


def output8bit(v):
    scaled = jnp.asarray(v, dtype=jnp.float32) * 256.0
    return jnp.clip(scaled, 0.0, 255.0).astype(jnp.uint8)


def output16bit(v):
    scaled = jnp.asarray(v, dtype=jnp.float32) * 65535.0
    # Rust f32::round() rounds half away from zero; jnp.round is half-to-even.
    rounded = jnp.trunc(scaled + jnp.where(scaled >= 0.0, 0.5, -0.5))
    return jnp.clip(rounded, 0.0, 65535.0).astype(jnp.uint16)
