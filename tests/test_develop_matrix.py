"""The XLA develop engine across the capture matrix: orientations, crops,
mono and X-Trans sensors, long tone curves, both numerics modes, batches
with per-image calibration on dp and dp x sp meshes, and thumbnails.

The fused engine is held to the staged per-op pipeline (which the golden
tests pin to the independent native implementation), and the scaled
demosaic of the thumbnail path to the scalar oracle (tests/oracle.py), all
within the cross-path contract: <=1 LSB with a small flip fraction.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from imagepipe_tpu import ImageSource, Pipeline, scaling
from imagepipe_tpu.engine import (develop_batch_fn, develop_fused,
                                  make_develop_plan, planar_to_hwc)
from imagepipe_tpu.parallel import BatchEngine, make_batch_mesh
from imagepipe_tpu.raw import (CFA, Orientation, synthetic_bayer,
                               synthetic_mono, synthetic_xtrans)

import oracle

ORIENTATIONS = ["Normal", "HorizontalFlip", "Rotate180", "VerticalFlip",
                "Transpose", "Rotate90", "Transverse", "Rotate270"]


def _contract(got, want, flip=0.01):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1, diff.max()
    assert (diff != 0).mean() < flip


def _pipe(raw, out_bits=8, maxwidth=0, maxheight=0):
    p = Pipeline.new_from_source(ImageSource.from_raw(raw))
    p.globals.settings.maxwidth = maxwidth
    p.globals.settings.maxheight = maxheight
    if out_bits == 16:
        p.globals.settings.linear = True
    return p


def _fused(raw, out_bits=8, maxwidth=0, maxheight=0, numerics="auto"):
    plan = make_develop_plan(_pipe(raw, out_bits, maxwidth, maxheight),
                             out_bits=out_bits, numerics=numerics)
    return planar_to_hwc(develop_fused(plan, raw.data))


def _staged(raw, out_bits=8, maxwidth=0, maxheight=0):
    p = _pipe(raw, out_bits, maxwidth, maxheight)
    p.globals.settings.use_fastpath = False  # the per-op chain
    out = p.output_8bit(None) if out_bits == 8 else p.output_16bit(None)
    return out.data


@pytest.mark.parametrize("out_bits", [8, 16])
@pytest.mark.parametrize("orient", ORIENTATIONS)
def test_fused_orientations_match_staged(orient, out_bits):
    """EXIF-rotated captures: the fused engine's in-jit output permutation
    matches the staged transform op for every orientation."""
    raw = synthetic_bayer(168, 112, seed=1)
    raw.orientation = Orientation(orient)
    got = _fused(raw, out_bits)
    if orient in ("Transpose", "Rotate90", "Transverse", "Rotate270"):
        assert got.shape == (raw.width, raw.height, 3)
    _contract(got, _staged(raw, out_bits))


@pytest.mark.parametrize("make_raw", [synthetic_bayer, synthetic_xtrans,
                                      synthetic_mono])
@pytest.mark.parametrize("out_bits", [8, 16])
def test_direct_numerics_within_contract(make_raw, out_bits):
    """The two numerics modes ('direct' transcendentals vs the reference's
    interpolated LUTs) agree within the cross-path contract."""
    raw = make_raw(168, 112, seed=2)
    _contract(_fused(raw, out_bits, numerics="direct"),
              _fused(raw, out_bits, numerics="lut"))


@pytest.mark.parametrize("make_raw", [synthetic_bayer, synthetic_xtrans])
@pytest.mark.parametrize("out_bits", [8, 16])
def test_fused_crops_match_staged(make_raw, out_bits):
    raw = make_raw(144, 108, seed=3)
    raw.crops = (2, 6, 4, 8)
    _contract(_fused(raw, out_bits), _staged(raw, out_bits))


@pytest.mark.parametrize("out_bits", [8, 16])
def test_mono_matches_staged(out_bits):
    raw = synthetic_mono(168, 112, seed=4)
    assert make_develop_plan(_pipe(raw, out_bits), out_bits).mode == "mono"
    _contract(_fused(raw, out_bits), _staged(raw, out_bits))


def test_mono_orientation_and_batch():
    raw = synthetic_mono(168, 112, seed=5)
    raw.orientation = Orientation.Rotate90
    plan = make_develop_plan(_pipe(raw), out_bits=8)
    single = planar_to_hwc(develop_fused(plan, raw.data))
    assert single.shape == (168, 112, 3)
    _contract(single, _staged(raw))
    batch = planar_to_hwc(develop_batch_fn(plan)(
        jnp.asarray(np.stack([raw.data] * 2))))
    np.testing.assert_array_equal(batch[0], single)
    np.testing.assert_array_equal(batch[1], single)


@pytest.mark.parametrize("numerics", ["lut", "direct"])
def test_many_knots_matches_staged(numerics):
    """A 24-knot tone curve through the fused spline evaluation."""
    raw = synthetic_bayer(168, 112, seed=6)
    p = _pipe(raw)
    p.ops.basecurve.points = [
        (i / 23.0, min(1.0, (i / 23.0) ** 0.8 + 0.01 * (i % 3)))
        for i in range(24)]
    plan = make_develop_plan(p, out_bits=8, numerics=numerics)
    assert plan.apply_curve and plan.n_knots > 16, plan.n_knots
    got = planar_to_hwc(develop_fused(plan, raw.data))
    p.globals.settings.use_fastpath = False
    _contract(got, p.output_8bit(None).data)


@pytest.mark.parametrize("spatial", [1, 2])
@pytest.mark.parametrize("make_raw", [synthetic_bayer, synthetic_xtrans,
                                      synthetic_mono])
def test_batch_engine_per_image_calibration_matrix(make_raw, spatial):
    """BatchEngine on a dp (8) and a dp x sp (4x2) mesh: per-image white
    balance survives batching, and every image matches its own
    single-image develop."""
    raws = [make_raw(144, 96, seed=60 + s) for s in range(5)]
    raws[3].wb_coeffs = (1.0, 1.0, 2.8, float("nan"))
    sources = [ImageSource.from_raw(r) for r in raws]
    eng = BatchEngine(make_batch_mesh(spatial=spatial), max_batch=8)
    outs = eng.develop_sources(sources)
    for raw, out in zip(raws, outs):
        _contract(out, _fused(raw))
    if make_raw is not synthetic_mono:
        assert not np.array_equal(outs[0], outs[3])


def test_batch_engine_sp_orientation():
    """Width-sharded batches with an EXIF rotation."""
    raws = [synthetic_bayer(144, 96, seed=70 + s) for s in range(4)]
    for r in raws:
        r.orientation = Orientation.Rotate90
    eng = BatchEngine(make_batch_mesh(spatial=2), max_batch=4)
    outs = eng.develop_sources([ImageSource.from_raw(r) for r in raws])
    for raw, out in zip(raws, outs):
        assert out.shape == (144, 96, 3)
        _contract(out, _fused(raw))


# -- thumbnails (the scaled demosaic path) ----------------------------------


@pytest.mark.parametrize("cfa_name", ["RGGB", "GBGGRG" "RGRBGB" "GBGGRG"
                                      "GRGGBG" "BGBRGR" "GRGGBG"])
@pytest.mark.parametrize("w,h,nw", [(96, 64, 24), (120, 90, 40),
                                    (144, 96, 30), (100, 76, 17),
                                    (132, 60, 44), (90, 120, 20)])
def test_scaled_demosaic_matches_oracle(cfa_name, w, h, nw):
    """The thumbnail path's fused demosaic+downscale (scale_down_planar
    with a CFA, as the engine calls it) against the scalar oracle."""
    cfa = CFA(cfa_name)
    nw_, nh = scaling.scaling_size(w, h, nw, nw)
    plane = np.random.default_rng(w + h + nw).random((h, w), dtype=np.float32)
    got = np.moveaxis(np.asarray(scaling.scale_down_planar(
        jnp.asarray(plane[None]), nw_, nh, 4, cfa=cfa)), 0, -1)
    want = oracle.transform_buffer(
        plane.ravel(), w, h, (0, 0), (w - 1, 0), (0, h - 1), nw_, nh, 4,
        cfa).reshape(nh, nw_, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("make_raw", [synthetic_bayer, synthetic_xtrans])
@pytest.mark.parametrize("out_bits", [8, 16])
def test_thumbnail_matches_staged(make_raw, out_bits):
    raw = make_raw(480, 320, seed=8)
    plan = make_develop_plan(_pipe(raw, out_bits, 96, 96), out_bits)
    assert plan.dem_path == "scaled"
    _contract(_fused(raw, out_bits, 96, 96), _staged(raw, out_bits, 96, 96))


def test_thumbnail_orientation_and_crops():
    raw = synthetic_bayer(480, 320, seed=9)
    raw.crops = (2, 6, 4, 8)
    raw.orientation = Orientation.Rotate270
    got = _fused(raw, 8, 80, 80)
    assert got.shape[0] > got.shape[1]          # transposed thumbnail
    _contract(got, _staged(raw, 8, 80, 80))


def test_thumbnail_float_plane():
    """f32 sensor payloads (DNG float) select exactly."""
    raw = synthetic_bayer(480, 320, seed=10)
    raw.data = (raw.data.astype(np.float32) * (1.0 / 3.0)).astype(np.float32)
    raw.whitelevels = tuple(float(w) / 3.0 for w in raw.whitelevels)
    raw.blacklevels = tuple(float(b) / 3.0 for b in raw.blacklevels)
    _contract(_fused(raw, 8, 96, 96), _staged(raw, 8, 96, 96))


def test_thumbnail_batch_per_image_params():
    raws = [synthetic_bayer(480, 320, seed=30 + s) for s in range(3)]
    raws[1].wb_coeffs = (1.0, 1.0, 2.8, float("nan"))
    eng = BatchEngine(max_batch=4, maxwidth=96, maxheight=96)
    outs = eng.develop_sources([ImageSource.from_raw(r) for r in raws])
    for raw, out in zip(raws, outs):
        _contract(out, _fused(raw, 8, 96, 96))
    assert not np.array_equal(outs[0], outs[1])


@pytest.mark.parametrize("trial", range(6))
def test_thumbnail_random_geometry(trial):
    """Random sensor sizes and maxsizes: ragged edges, odd aspect ratios,
    scales from the minscale boundary to deep previews."""
    rng = np.random.default_rng(55 + trial)
    w = int(rng.integers(160, 420)) & ~1
    h = int(rng.integers(120, 300)) & ~1
    mw = int(rng.integers(max(w // 12, 12), w // 2))
    raw = synthetic_bayer(w, h, seed=100 + trial)
    _contract(_fused(raw, 8, mw, mw), _staged(raw, 8, mw, mw))


@pytest.mark.parametrize("make_raw,out_bits", [
    (synthetic_bayer, 8), (synthetic_bayer, 16), (synthetic_xtrans, 8)])
def test_deep_thumbnail_matches_staged(make_raw, out_bits):
    """Deep scales (window spans > 16 source pixels per axis)."""
    raw = make_raw(720, 480, seed=7)
    plan = make_develop_plan(_pipe(raw, out_bits, 36, 36), out_bits)
    assert plan.dem_path == "scaled"
    _contract(_fused(raw, out_bits, 36, 36), _staged(raw, out_bits, 36, 36))
