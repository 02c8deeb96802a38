"""Rotated geometry through the gather resampler (scaling._transform_impl)
against the scalar oracle, across angles, scales, sizes and channel counts.

At near-45-degree angles the reference's corner-pair windows degenerate
(to-from = cos-sin -> 0), so weight sums approach zero and ULP differences
amplify through sums/counts; the envelope below is the one that
degeneracy allows (scaling.rs:84-107 semantics).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from imagepipe_tpu import scaling
from imagepipe_tpu.buffer import OpBuffer
from imagepipe_tpu.ops.rotatecrop import OpRotateCrop

import oracle

f32 = np.float32


def _corners(theta_deg, w, h, nw, nh, scale=1.0):
    """Inverse-map corner triple like OpRotateCrop._rotate_point_reverse."""
    a = np.deg2rad(theta_deg)
    s, c = np.sin(a), np.cos(a)

    def rot(x, y):
        tx, ty = x - nw / 2, y - nh / 2
        return (int(f32((tx * c + ty * s) * scale + w / 2)),
                int(f32((-tx * s + ty * c) * scale + h / 2)))

    return rot(0, 0), rot(nw - 1, 0), rot(0, nh - 1)


def _oracle(data, w, h, tl, tr, bl, nw, nh, C):
    return oracle.transform_buffer(
        data.ravel(), w, h, tl, tr, bl, nw, nh, C).reshape(nh, nw, C)


def _envelope(got, want):
    diff = np.abs(got - want)
    # Healthy-window pixels agree to 1e-4; degenerate near-empty windows
    # amplify ULPs through sums/counts.
    assert (diff > 1e-4).mean() < 0.005
    assert diff.max() < 5e-3


CASES = [
    # (theta, w, h, nw, nh, scale, C)
    (4, 60, 48, 56, 44, 1.0, 4),
    (27, 64, 56, 60, 52, 1.0, 3),
    (45, 52, 52, 72, 72, 1.0, 4),     # degenerate windows, half-empty
    (45, 56, 40, 60, 44, 1.4, 4),
    (75, 48, 48, 44, 44, 1.0, 1),     # mostly-empty windows
    (12, 80, 36, 36, 16, 2.2, 4),     # rotation + downscale
]


@pytest.mark.parametrize("theta,w,h,nw,nh,sc,C", CASES)
def test_gather_rotation_matches_oracle(theta, w, h, nw, nh, sc, C):
    rng = np.random.default_rng(theta * 13 + C)
    tl, tr, bl = _corners(theta, w, h, nw, nh, sc)
    data = rng.random((h, w, C), dtype=np.float32)
    got = np.asarray(scaling.transform_buffer(
        jnp.asarray(data), w, h, tl, tr, bl, nw, nh, C))
    _envelope(got, _oracle(data, w, h, tl, tr, bl, nw, nh, C))


@pytest.mark.parametrize("C", [1, 3, 4])
@pytest.mark.parametrize("theta", [5, 18, 33, 60])
def test_planar_rotation_matches_hwc(theta, C):
    """transform_buffer_planar (the rotatecrop op's entry) routes rotated
    geometry through the same gather loop as the HWC entry."""
    rng = np.random.default_rng(theta + 7 * C)
    w, h, nw, nh = 70, 56, 64, 50
    tl, tr, bl = _corners(theta, w, h, nw, nh)
    data = rng.random((h, w, C), dtype=np.float32)
    planar = np.asarray(scaling.transform_buffer_planar(
        jnp.moveaxis(jnp.asarray(data), -1, 0), w, h, tl, tr, bl, nw, nh, C))
    hwc = np.asarray(scaling.transform_buffer(
        jnp.asarray(data), w, h, tl, tr, bl, nw, nh, C))
    np.testing.assert_array_equal(np.moveaxis(planar, 0, -1), hwc)


@pytest.mark.parametrize("trial", range(6))
def test_random_affine_matches_oracle(trial):
    """Random corner triples: shears, mirrored axes, out-of-bounds corners."""
    rng = np.random.default_rng(77 + trial)
    w, h = int(rng.integers(24, 60)), int(rng.integers(24, 60))
    nw, nh = int(rng.integers(16, 48)), int(rng.integers(16, 48))
    tl = (int(rng.integers(-12, w + 12)), int(rng.integers(-12, h + 12)))
    tr = (tl[0] + int(rng.integers(-w, w)), tl[1] + int(rng.integers(-h, h)))
    bl = (tl[0] + int(rng.integers(-w, w)), tl[1] + int(rng.integers(-h, h)))
    data = rng.random((h, w, 3), dtype=np.float32)
    got = np.asarray(scaling.transform_buffer(
        jnp.asarray(data), w, h, tl, tr, bl, nw, nh, 3))
    _envelope(got, _oracle(data, w, h, tl, tr, bl, nw, nh, 3))


def test_degenerate_geometry_renders():
    """A zero x-step (vertical degenerate geometry) still renders."""
    rng = np.random.default_rng(1)
    data = rng.random((40, 40, 4), dtype=np.float32)
    out = scaling.transform_buffer(
        jnp.asarray(data), 40, 40, (5, 0), (5, 20), (0, 39), 24, 24, 4)
    assert out.shape == (24, 24, 4)
    assert np.isfinite(np.asarray(out)).all()


def test_rotatecrop_op_matches_oracle_quantized():
    """The rotatecrop op end to end: quantized outputs within 1 LSB of the
    oracle resampling of the same corners."""
    rng = np.random.default_rng(99)
    w, h = 72, 56
    data = rng.random((h, w, 4), dtype=np.float32)
    op = OpRotateCrop.empty()
    op.rotation = 0.21
    op.crop_left = 0.04
    op.crop_top = 0.02
    out = op.run(None, OpBuffer.from_hwc(data))
    got = np.asarray(out.to_hwc())
    nw, nh = out.width, out.height
    # The corners the op hands the resampler (rotatecrop.rs:39-64).
    sw, sh = f32(w), f32(h)
    x = float(np.floor(f32(sw * f32(op.crop_left))))
    y = float(np.floor(f32(sh * f32(op.crop_top))))
    fw, fh = f32(nw), f32(nh)
    tl = op._rotate_point_reverse(x, y, fw, fh, sw, sh)
    tr = op._rotate_point_reverse(f32(f32(x) + fw - f32(1.0)), y, fw, fh, sw, sh)
    bl = op._rotate_point_reverse(x, f32(f32(y) + fh - f32(1.0)), fw, fh, sw, sh)
    want = _oracle(data, w, h, tl, tr, bl, nw, nh, 4)
    q = lambda a: np.clip(np.trunc(a * 256.0), 0, 255).astype(int)
    diff = np.abs(q(got) - q(want))
    assert diff.max() <= 1
    assert (diff != 0).mean() < 0.01
