"""Pipeline orchestration: RAW develop end-to-end, stage cache dirty-suffix
re-render, YAML serialization round-trip, CLI."""

import numpy as np
import pytest

from imagepipe_tpu import ImageSource, Pipeline, PipelineOps
from imagepipe_tpu.raw import synthetic_bayer, synthetic_xtrans


def test_raw_develop_end_to_end():
    raw = synthetic_bayer(200, 120)
    p = Pipeline.new_from_source(ImageSource.from_raw(raw))
    out = p.output_8bit(None)
    assert (out.width, out.height) == (200, 120)
    assert out.data.dtype == np.uint8
    # The synthetic scene is mid-toned: output must not be black or clipped.
    assert 20 < out.data.mean() < 235


def test_raw_develop_16bit_linear():
    raw = synthetic_bayer(200, 120)
    p = Pipeline.new_from_source(ImageSource.from_raw(raw))
    out = p.output_16bit(None)
    assert out.data.dtype == np.uint16
    assert (out.width, out.height) == (200, 120)


def test_raw_develop_xtrans():
    raw = synthetic_xtrans(180, 120)
    p = Pipeline.new_from_source(ImageSource.from_raw(raw))
    out = p.output_8bit(None)
    assert (out.width, out.height) == (180, 120)


def test_raw_thumbnail_fused_demosaic():
    raw = synthetic_bayer(400, 300)
    p = Pipeline.new_from_source(ImageSource.from_raw(raw))
    p.globals.settings.maxwidth = 100
    p.globals.settings.maxheight = 100
    out = p.output_8bit(None)
    assert (out.width, out.height) == (100, 75)


def test_default_ops_detection():
    raw = synthetic_bayer(64, 48)
    p = Pipeline.new_from_source(ImageSource.from_raw(raw))
    assert p.default_ops()
    p.ops.basecurve.exposure = 0.7
    assert not p.default_ops()


def test_stage_cache_dirty_suffix():
    """Edit a late op: the cache must resume from the stage before it
    (pipeline.rs:354-372 'latest hit wins')."""
    raw = synthetic_bayer(120, 90)
    p = Pipeline.new_from_source(ImageSource.from_raw(raw))
    cache = Pipeline.new_cache(200 << 20)
    first = p.output_8bit(cache)
    n_after_first = len(cache)
    assert n_after_first == 8

    # Identical rerun: full cache hit, no new entries.
    again = p.output_8bit(cache)
    np.testing.assert_array_equal(first.data, again.data)
    assert len(cache) == n_after_first

    # Change the tone curve (stage 5): stages 5..8 recompute, 4 new entries.
    p.ops.basecurve.exposure = 0.5
    third = p.output_8bit(cache)
    assert len(cache) == n_after_first + 4
    assert not np.array_equal(first.data, third.data)

    # Cached rerun of the edited pipeline is identical.
    fourth = p.output_8bit(cache)
    np.testing.assert_array_equal(third.data, fourth.data)


def test_cache_respects_linear_flag():
    """8-bit and 16-bit outputs flip settings.linear, which participates in
    the hash chain -- they must not collide in the cache."""
    raw = synthetic_bayer(80, 60)
    p = Pipeline.new_from_source(ImageSource.from_raw(raw))
    cache = Pipeline.new_cache(200 << 20)
    out8 = p.output_8bit(cache)
    out16 = p.output_16bit(cache)
    out8b = p.output_8bit(cache)
    np.testing.assert_array_equal(out8.data, out8b.data)
    # 16-bit linear output of a midtone scene differs from gamma-encoded.
    assert not np.array_equal(out8.data, (out16.data >> 8).astype(np.uint8))


def test_serial_roundtrip():
    raw = synthetic_bayer(64, 48)
    p = Pipeline.new_from_source(ImageSource.from_raw(raw))
    p.ops.basecurve.exposure = 0.25
    p.ops.rotatecrop.crop_left = 0.125
    from imagepipe_tpu.ops.transform import Rotation

    p.ops.transform.rotation = Rotation.Rotate90
    serial = p.to_serial()

    p2 = Pipeline.new_from_serial(ImageSource.from_raw(raw), serial)
    assert p2.ops.basecurve.exposure == 0.25
    assert p2.ops.rotatecrop.crop_left == 0.125
    assert p2.ops.transform.rotation == Rotation.Rotate90
    assert p.ops == p2.ops
    out1 = p.output_8bit(None)
    out2 = p2.output_8bit(None)
    np.testing.assert_array_equal(out1.data, out2.data)


def test_decode_file_and_cli(tmp_path):
    from imagepipe_tpu.decode import save_synraw
    from imagepipe_tpu import simple_decode_8bit
    from imagepipe_tpu.cli import main as cli_main
    from PIL import Image

    raw = synthetic_bayer(96, 64)
    path = str(tmp_path / "shot.synraw.npz")
    save_synraw(path, raw)
    out = simple_decode_8bit(path, 48, 0)
    assert (out.width, out.height) == (48, 32)

    # CLI end-to-end to JPEG.
    rc = cli_main(["converter", path, str(tmp_path / "out.jpg")])
    assert rc == 0
    jpg = Image.open(tmp_path / "out.jpg")
    assert jpg.size == (96, 64)

    # raster path through PIL
    png = tmp_path / "img.png"
    Image.fromarray(np.full((20, 30, 3), 128, np.uint8)).save(png)
    out = simple_decode_8bit(str(png))
    assert (out.width, out.height) == (30, 20)
    np.testing.assert_array_equal(out.data, 128)

    with pytest.raises(Exception):
        simple_decode_8bit(str(tmp_path / "nope.png"))


def test_monochrome_raw():
    """cpp=1 non-CFA RAW: replicated to RGB with identity color handling
    (gofloat.rs:97-109, colorspaces.rs:90-101)."""
    from imagepipe_tpu.raw import CFA, Orientation, RawImage

    h, w = 40, 60
    grad = (np.linspace(0, 16383, w, dtype=np.uint16)[None, :]
            * np.ones((h, 1), np.uint16))
    raw = RawImage(
        width=w, height=h, cpp=1, crops=(0, 0, 0, 0),
        blacklevels=(0,) * 4, whitelevels=(16383,) * 4,
        wb_coeffs=(1.0, 1.0, 1.0, 0.0),
        xyz_to_cam=np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [0, 0, 0]], np.float32),
        orientation=Orientation.Normal, cfa=CFA(""), data=grad)
    p = Pipeline.new_from_source(ImageSource.from_raw(raw))
    out = p.output_8bit(None)
    # Monochrome: all three channels identical.
    np.testing.assert_array_equal(out.data[..., 0], out.data[..., 1])
    np.testing.assert_array_equal(out.data[..., 0], out.data[..., 2])
    # Gradient increases monotonically.
    col_means = out.data[..., 0].mean(axis=0)
    assert col_means[-1] > col_means[0] + 100


def test_exif_orientation_applied():
    raw = synthetic_bayer(100, 60)
    from imagepipe_tpu.raw import Orientation

    raw.orientation = Orientation.Rotate90
    p = Pipeline.new_from_source(ImageSource.from_raw(raw))
    out = p.output_8bit(None)
    assert (out.width, out.height) == (60, 100)


def test_profiling_helpers():
    from imagepipe_tpu import profiling
    import jax.numpy as jnp

    def f(x):
        return x * 2.0

    out, secs = profiling.timed_sync(f, jnp.ones((64, 64)), iters=2)
    assert secs >= 0.0
    import numpy as np

    np.testing.assert_allclose(np.asarray(out), 2.0)


def test_vpu_pass_census_pins_numerics_mode():
    """The elementwise census pins what each numerics mode computes: in
    'direct' numerics the traced develop chain holds ZERO gather-class
    elements and a fixed exp/log budget, while 'lut' mode (the CPU
    golden-parity path) gathers from the LUTs."""
    from imagepipe_tpu import profiling
    from imagepipe_tpu.engine import make_develop_plan
    from imagepipe_tpu.raw import synthetic_bayer

    raw = synthetic_bayer(seed=5, width=96, height=64)
    p = Pipeline.new_from_source(ImageSource.from_raw(raw))
    c_direct = profiling.vpu_pass_census(
        make_develop_plan(p, out_bits=8, numerics="direct"))
    assert c_direct["per_px_serialized"] == 0.0
    # exp/log budget: 3 Lab cbrt forms + 3 sRGB gamma forms per pixel.
    assert c_direct["per_px_transcendental"] == pytest.approx(12.0, abs=1.0)
    assert c_direct["per_px_cheap"] > 50
    assert not c_direct["unclassified"], c_direct["unclassified"]

    c_lut = profiling.vpu_pass_census(
        make_develop_plan(p, out_bits=8, numerics="lut"))
    assert c_lut["per_px_serialized"] > 0.5


def test_float_raw_data():
    """RawImageData::Float equivalent: f32 sensor payloads develop through
    the same levels math (gofloat.rs:132-167)."""
    from imagepipe_tpu.raw import CFA, Orientation, RawImage

    h, w = 48, 64
    rng = np.random.default_rng(0)
    data = rng.uniform(0.0, 1.0, (h, w)).astype(np.float32)
    raw = RawImage(
        width=w, height=h, cpp=1, crops=(0, 0, 0, 0),
        blacklevels=(0,) * 4, whitelevels=(1,) * 4,
        wb_coeffs=(2.0, 1.0, 1.5, float("nan")),
        xyz_to_cam=np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [0, 0, 0]], np.float32),
        orientation=Orientation.Normal, cfa=CFA("RGGB"), data=data)
    out = Pipeline.new_from_source(ImageSource.from_raw(raw)).output_8bit(None)
    assert (out.width, out.height) == (w, h)
    assert out.data.std() > 0


def test_cpp3_rgb_raw():
    """cpp=3 linear-RGB RAW (gofloat.rs:110-121): demosaic passes through."""
    from imagepipe_tpu.raw import CFA, Orientation, RawImage

    h, w = 40, 56
    rng = np.random.default_rng(1)
    data = rng.integers(100, 16000, (h, w, 3)).astype(np.uint16)
    raw = RawImage(
        width=w, height=h, cpp=3, crops=(0, 0, 0, 0),
        blacklevels=(100,) * 4, whitelevels=(16383,) * 4,
        wb_coeffs=(1.0, 1.0, 1.0, 0.0),
        xyz_to_cam=np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [0, 0, 0]], np.float32),
        orientation=Orientation.Normal, cfa=CFA(""), data=data)
    p = Pipeline.new_from_source(ImageSource.from_raw(raw))
    out = p.output_8bit(None)
    assert (out.width, out.height) == (w, h)
    # fused path agrees with staged
    p2 = Pipeline.new_from_source(ImageSource.from_raw(raw))
    p2.globals.settings.use_fastpath = False
    staged = p2.output_8bit(None)
    assert np.abs(out.data.astype(int) - staged.data.astype(int)).max() <= 1


def test_single_op_to_settings_yaml():
    """ImageOp.to_settings parity (pipeline.rs:85-87): per-op YAML."""
    import yaml

    raw = synthetic_bayer(64, 48)
    p = Pipeline.new_from_source(ImageSource.from_raw(raw))
    doc = yaml.safe_load(p.ops.basecurve.to_settings())
    assert doc["exposure"] == 0.0
    assert doc["points"] == [[0.5, 0.6]]


def test_cache_eviction_exact_semantics():
    """MultiCache LRU semantics, asserted exactly: eviction order, byte
    accounting after forced eviction, and the over-budget-singleton rule
    (the newest entry is always retained, even alone over budget)."""
    from imagepipe_tpu.cache import MultiCache

    c = MultiCache(100)
    c.put(b"a", "A", 40)
    c.put(b"b", "B", 40)
    assert (len(c), c.total_bytes) == (2, 80)
    c.put(b"c", "C", 40)  # 120 > 100: evicts oldest ("a") exactly
    assert (len(c), c.total_bytes) == (2, 80)
    assert c.get(b"a") is None and c.get(b"b") == "B" and c.get(b"c") == "C"
    # get() refreshes recency: "c" was touched last above, so inserting "d"
    # evicts "b" (now the least recently used).
    c.put(b"d", "D", 40)
    assert (len(c), c.total_bytes) == (2, 80)
    assert c.get(b"b") is None and c.get(b"c") == "C"
    # Over-budget singleton: a put larger than the whole budget evicts
    # everything else but is itself retained.
    c.put(b"e", "E", 150)
    assert (len(c), c.total_bytes) == (1, 150)
    assert c.get(b"e") == "E"
    # Next normal put brings the cache back under budget.
    c.put(b"f", "F", 30)
    assert (len(c), c.total_bytes) == (1, 30)
    assert c.get(b"e") is None and c.get(b"f") == "F"
    # Re-putting an existing key replaces its weight (no double counting).
    c.put(b"f", "F2", 50)
    assert (len(c), c.total_bytes) == (1, 50)


def test_cache_eviction_under_pressure():
    """Byte-budgeted LRU through the pipeline: a small cache evicts oldest
    stages but re-renders stay correct."""
    raw = synthetic_bayer(120, 80)
    p = Pipeline.new_from_source(ImageSource.from_raw(raw))
    # Budget for only ~3 full-size f32 stages.
    cache = Pipeline.new_cache(3 * 120 * 80 * 4 * 4)
    a = p.output_8bit(cache)
    assert len(cache) >= 1
    assert cache.total_bytes <= cache.max_bytes  # multi-entry => under budget
    b = p.output_8bit(cache)  # still correct with partial cache
    np.testing.assert_array_equal(a.data, b.data)


def test_cache_smaller_than_one_stage_recompute():
    """A cache too small for even one stage keeps exactly the newest stage
    (over-budget singleton) and never corrupts results."""
    raw = synthetic_bayer(120, 80)
    p = Pipeline.new_from_source(ImageSource.from_raw(raw))
    cache = Pipeline.new_cache(16)  # smaller than any stage buffer
    a = p.output_8bit(cache)
    assert len(cache) == 1  # only the newest stage survives
    b = p.output_8bit(cache)
    np.testing.assert_array_equal(a.data, b.data)
    # Edit an op: full recompute through the tiny cache, still correct.
    p.ops.basecurve.exposure = 0.25
    c1 = p.output_8bit(cache)
    p2 = Pipeline.new_from_source(ImageSource.from_raw(raw))
    p2.ops.basecurve.exposure = 0.25
    c2 = p2.output_8bit(None)
    np.testing.assert_array_equal(c1.data, c2.data)


def test_rotatecrop_rotation_through_pipeline():
    """Free rotation through the whole pipeline (size from the 45-degree
    bounding box, rotatecrop.rs:111-163)."""
    raw = synthetic_bayer(100, 100)
    p = Pipeline.new_from_source(ImageSource.from_raw(raw))
    p.ops.rotatecrop.rotation = 0.5
    out = p.output_8bit(None)
    assert (out.width, out.height) == (141, 141)
    # Rotated corners are outside the source -> zero (black) after develop.
    assert out.data[0, 0].sum() <= out.data[70, 70].sum()
