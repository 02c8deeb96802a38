"""Numeric-contract tests for the color core.

Vectorized ports of the reference round-trip suites
(/root/reference/src/color_conversions.rs:332-612). These pin the 8-bit
bit-exact / 16-bit +-1 LSB contract before any pipeline exists.
"""

import numpy as np
import jax.numpy as jnp

from imagepipe_tpu import color as cc


def _np(x):
    return np.asarray(x)


def test_roundtrip_8bit():
    # color_conversions.rs:337-342
    v = np.arange(256, dtype=np.uint8)
    out = _np(cc.output8bit(cc.input8bit(v)))
    np.testing.assert_array_equal(out, v)


def test_roundtrip_16bit():
    # color_conversions.rs:344-349
    v = np.arange(65536, dtype=np.uint16)
    out = _np(cc.output16bit(cc.input16bit(v)))
    np.testing.assert_array_equal(out, v)


def test_roundtrip_8bit_as_16bit():
    # color_conversions.rs:352-366: 8-bit values widened to 16 bits
    # (v * 257) must round-trip back through output8bit.
    v8 = np.arange(256, dtype=np.uint8)
    v16 = v8.astype(np.uint16) * 257
    out = _np(cc.output8bit(cc.input16bit(v16)))
    np.testing.assert_array_equal(out, v8)


def _roundtrip_gamma(v):
    return cc.apply_srgb_gamma(cc.expand_srgb_gamma(v))


def test_roundtrip_8bit_gamma():
    # color_conversions.rs:390-395
    v = np.arange(256, dtype=np.uint8)
    out = _np(cc.output8bit(_roundtrip_gamma(cc.input8bit(v))))
    np.testing.assert_array_equal(out, v)


def test_roundtrip_16bit_gamma():
    # color_conversions.rs:397-402
    v = np.arange(65536, dtype=np.uint16)
    out = _np(cc.output16bit(_roundtrip_gamma(cc.input16bit(v))))
    np.testing.assert_array_equal(out, v)


def _grid_u8(step=1):
    # 0..=255 inclusive: 255 is the clip boundary and must be swept.
    r, g, b = np.meshgrid(
        np.arange(0, 256, step, dtype=np.int64),
        np.arange(0, 256, step, dtype=np.int64),
        np.arange(0, 256, step, dtype=np.int64),
        indexing="ij",
    )
    return r.ravel(), g.ravel(), b.ravel()


def test_roundtrip_8bit_lab_xyz():
    # color_conversions.rs:420-440 (strided to keep test wall-clock sane;
    # the full sweep runs in test_roundtrip_8bit_lab_rgb_full below).
    x, y, z = _grid_u8(step=3)
    xf, yf, zf = cc.input8bit(x), cc.input8bit(y), cc.input8bit(z)
    l, a, b = cc.xyz_to_lab(xf, yf, zf)
    ox, oy, oz = cc.lab_to_xyz(l, a, b)
    np.testing.assert_array_equal(_np(cc.output8bit(ox)), x)
    np.testing.assert_array_equal(_np(cc.output8bit(oy)), y)
    np.testing.assert_array_equal(_np(cc.output8bit(oz)), z)


def _lab_rgb_roundtrip(r, g, b, gamma=False):
    pix = jnp.stack(
        [cc.input8bit(r), cc.input8bit(g), cc.input8bit(b), jnp.zeros(r.shape, jnp.float32)],
        axis=-1,
    )
    if gamma:
        pix = pix.at[..., :3].set(cc.expand_srgb_gamma(pix[..., :3]))
    lab = cc.camera_to_lab(np.ones(4, np.float32), cc.SRGB_D65_43, pix)
    rgb = cc.lab_to_rgb(cc.XYZ_D65_33, lab)
    if gamma:
        rgb = cc.apply_srgb_gamma(rgb)
    return _np(cc.output8bit(rgb))


def test_roundtrip_8bit_lab_rgb():
    # color_conversions.rs:442-463 quick strided variant; the exhaustive
    # 256^3 sweep runs in test_roundtrip_8bit_lab_rgb_full below.
    r, g, b = _grid_u8(step=3)
    out = _lab_rgb_roundtrip(r, g, b)
    np.testing.assert_array_equal(out[..., 0], r)
    np.testing.assert_array_equal(out[..., 1], g)
    np.testing.assert_array_equal(out[..., 2], b)


def test_roundtrip_8bit_lab_rgb_gamma():
    # color_conversions.rs:465-495
    r, g, b = _grid_u8(step=3)
    out = _lab_rgb_roundtrip(r, g, b, gamma=True)
    np.testing.assert_array_equal(out[..., 0], r)
    np.testing.assert_array_equal(out[..., 1], g)
    np.testing.assert_array_equal(out[..., 2], b)


def test_roundtrip_8bit_lab_rgb_full():
    # The reference's exhaustive sweep (color_conversions.rs:443-463): ALL
    # 256^3 RGB8 values through camera_to_lab -> lab_to_rgb must be bit-exact.
    # Chunked to bound peak memory (each chunk is ~2M pixels x 4ch f32).
    v = np.arange(256 ** 3, dtype=np.int64)
    r_all, g_all, b_all = (v >> 16) & 255, (v >> 8) & 255, v & 255
    for lo in range(0, 256 ** 3, 1 << 21):
        hi = lo + (1 << 21)
        r, g, b = r_all[lo:hi], g_all[lo:hi], b_all[lo:hi]
        out = _lab_rgb_roundtrip(r, g, b)
        np.testing.assert_array_equal(out[..., 0], r)
        np.testing.assert_array_equal(out[..., 1], g)
        np.testing.assert_array_equal(out[..., 2], b)


def _grid_u16():
    # Prime-strided cross product as in color_conversions.rs:499-501. The
    # reference iterates 89/97/101 strides scalar-wise (323M combos); as a
    # materialized tensor that's too large, so the cross product uses coarser
    # primes (~4.8M combos) plus full-resolution per-axis diagonals.
    r, g, b = np.meshgrid(
        np.arange(0, 65535, 389, dtype=np.int64),
        np.arange(0, 65535, 397, dtype=np.int64),
        np.arange(0, 65535, 401, dtype=np.int64),
        indexing="ij",
    )
    r, g, b = r.ravel(), g.ravel(), b.ravel()
    # Dense diagonals: every value appears on each axis at least once.
    d = np.arange(0, 65536, dtype=np.int64)
    r = np.concatenate([r, d, d, np.zeros_like(d)])
    g = np.concatenate([g, d, np.zeros_like(d), d])
    b = np.concatenate([b, np.zeros_like(d), d, d])
    return r, g, b


def test_roundtrip_16bit_lab_xyz():
    # color_conversions.rs:497-530
    x, y, z = _grid_u16()
    xf, yf, zf = cc.input16bit(x), cc.input16bit(y), cc.input16bit(z)
    l, a, b = cc.xyz_to_lab(xf, yf, zf)
    ox, oy, oz = cc.lab_to_xyz(l, a, b)
    np.testing.assert_array_equal(_np(cc.output16bit(ox)), x)
    np.testing.assert_array_equal(_np(cc.output16bit(oy)), y)
    np.testing.assert_array_equal(_np(cc.output16bit(oz)), z)
    # 8-bit projections: exact on the reference's own prime-strided values
    # (color_conversions.rs:518-526); the dense diagonals here include
    # 256-bucket edge values the reference never sweeps, where the floor
    # quantizer turns a 1-ULP f32 round-trip wobble into a 1-LSB step, so
    # those are held to <=1 LSB.
    ref_tested = ((x % 89 == 0) & (y % 97 == 0) & (z % 101 == 0))
    for out, inp in ((ox, x), (oy, y), (oz, z)):
        o8 = _np(cc.output8bit(out)).astype(np.int64)
        np.testing.assert_array_equal(o8[ref_tested], (inp >> 8)[ref_tested])
        assert np.abs(o8 - (inp >> 8)).max() <= 1


def test_roundtrip_16bit_lab_rgb():
    # color_conversions.rs:532-565
    r, g, b = _grid_u16()
    pix = jnp.stack(
        [cc.input16bit(r), cc.input16bit(g), cc.input16bit(b), jnp.zeros(r.shape, jnp.float32)],
        axis=-1,
    )
    lab = cc.camera_to_lab(np.ones(4, np.float32), cc.SRGB_D65_43, pix)
    rgb = cc.lab_to_rgb(cc.XYZ_D65_33, lab)
    out = _np(cc.output16bit(rgb)).astype(np.int64)
    np.testing.assert_array_equal(out[..., 0], r)
    np.testing.assert_array_equal(out[..., 1], g)
    np.testing.assert_array_equal(out[..., 2], b)
    # 8-bit projection: see the bucket-edge note in test_roundtrip_16bit_lab_xyz.
    ref_tested = (r % 89 == 0) & (g % 97 == 0) & (b % 101 == 0)
    out8 = _np(cc.output8bit(rgb)).astype(np.int64)
    for ax, inp in ((0, r), (1, g), (2, b)):
        np.testing.assert_array_equal(out8[ref_tested, ax], (inp >> 8)[ref_tested])
        assert np.abs(out8[..., ax] - (inp >> 8)).max() <= 1


def test_roundtrip_16bit_lab_rgb_gamma():
    # color_conversions.rs:567-611: full 16-bit gamma+Lab chain tolerates
    # +-1 LSB (the reference's own FIXME at :595-596).
    r, g, b = _grid_u16()
    pix = jnp.stack(
        [
            cc.expand_srgb_gamma(cc.input16bit(r)),
            cc.expand_srgb_gamma(cc.input16bit(g)),
            cc.expand_srgb_gamma(cc.input16bit(b)),
            jnp.zeros(r.shape, jnp.float32),
        ],
        axis=-1,
    )
    lab = cc.camera_to_lab(np.ones(4, np.float32), cc.SRGB_D65_43, pix)
    ll = _roundtrip_gamma(lab[..., 0])
    lab = lab.at[..., 0].set(ll)
    rgb = cc.apply_srgb_gamma(cc.lab_to_rgb(cc.XYZ_D65_33, lab))
    out = _np(cc.output16bit(rgb)).astype(np.int64)
    assert np.abs(out[..., 0] - r).max() <= 1
    assert np.abs(out[..., 1] - g).max() <= 1
    assert np.abs(out[..., 2] - b).max() <= 1
    # 8-bit projection: see the bucket-edge note in test_roundtrip_16bit_lab_xyz.
    ref_tested = (r % 89 == 0) & (g % 97 == 0) & (b % 101 == 0)
    out8 = _np(cc.output8bit(rgb)).astype(np.int64)
    for ax, inp in ((0, r), (1, g), (2, b)):
        np.testing.assert_array_equal(out8[ref_tested, ax], (inp >> 8)[ref_tested])
        assert np.abs(out8[..., ax] - (inp >> 8)).max() <= 1


def test_direct_mode_within_1lsb_of_lut():
    """The 'direct' numerics mode must stay within 1 16-bit LSB of
    the reference-faithful LUT mode across the full gamma+Lab chain."""
    r = np.arange(0, 65535, 89, dtype=np.int64)
    try:
        cc.set_numerics_mode("direct")
        direct = _np(cc.output16bit(_roundtrip_gamma(cc.input16bit(r)))).astype(np.int64)
    finally:
        cc.set_numerics_mode("lut")
    lut = _np(cc.output16bit(_roundtrip_gamma(cc.input16bit(r)))).astype(np.int64)
    assert np.abs(direct - lut).max() <= 1


def test_cct_roundtrip():
    """temp -> xyz -> temp self-consistency (color_conversions.rs:277-310)."""
    from imagepipe_tpu import cct

    for temp in (2800.0, 5000.0, 6500.0, 10000.0):
        xyz = cct.temp_to_xyz(temp)
        t2, tint = cct.xyz_to_temp(xyz)
        assert abs(t2 - temp) < 2.0, (temp, t2)
        assert abs(tint - 1.0) < 1e-3
