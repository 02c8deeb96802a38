"""Fused dirty-suffix dispatch (pipeline._run_suffix_fused).

The staged interactive path collapses a cached run's dirty suffix into ONE
jit when every remaining op joins via ImageOp.device_chain. The contract:
bit-identical outputs to the per-stage path (stages are barrier-separated
inside the jit, so each stage's arithmetic is the standalone kernel's),
and identical stage-cache population (every intermediate cached under its
chain hash — cache resume depth unchanged).
"""

import numpy as np
import pytest

import imagepipe_tpu.pipeline as plmod
from imagepipe_tpu import ImageSource, Pipeline
from imagepipe_tpu.raw import Orientation, synthetic_bayer


def _develop_with_edit(fuse, *, out16=False, orientation=None, edits=None):
    raw = synthetic_bayer(96, 72)
    if orientation is not None:
        raw.orientation = orientation
    old = plmod.FUSE_SUFFIX
    plmod.FUSE_SUFFIX = fuse
    try:
        p = Pipeline.new_from_source(ImageSource.from_raw(raw))
        cache = Pipeline.new_cache(200 << 20)
        out = p.output_16bit(cache) if out16 else p.output_8bit(cache)
        outs = [np.array(out.data)]
        for ed in (edits or [{"exposure": 0.25}, {"exposure": 0.3}]):
            for k, v in ed.items():
                setattr(p.ops.basecurve, k, v)
            out = p.output_16bit(cache) if out16 else p.output_8bit(cache)
            outs.append(np.array(out.data))
        return outs, cache
    finally:
        plmod.FUSE_SUFFIX = old


def test_fused_suffix_bit_equals_staged_8bit():
    fused, cf = _develop_with_edit(True)
    staged, cs = _develop_with_edit(False)
    for f, s in zip(fused, staged):
        np.testing.assert_array_equal(f, s)
    # Identical cache population: same entry count after the same edits.
    assert len(cf) == len(cs)


def test_fused_suffix_bit_equals_staged_16bit_linear():
    # 16-bit output sets settings.linear -> gamma becomes an identity
    # stage inside the fused suffix.
    fused, _ = _develop_with_edit(True, out16=True)
    staged, _ = _develop_with_edit(False, out16=True)
    for f, s in zip(fused, staged):
        np.testing.assert_array_equal(f, s)


@pytest.mark.parametrize("orientation", [
    Orientation.Rotate90, Orientation.Rotate180, Orientation.Transverse])
def test_fused_suffix_bit_equals_staged_oriented(orientation):
    # transform is a real (non-identity) stage: flips/transpose traced into
    # the fused suffix must match rotate_buffer exactly, including the
    # width/height swap on transposing orientations.
    fused, _ = _develop_with_edit(True, orientation=orientation)
    staged, _ = _develop_with_edit(False, orientation=orientation)
    for f, s in zip(fused, staged):
        assert f.shape == s.shape
        np.testing.assert_array_equal(f, s)


def test_fused_suffix_cache_resume_depth_unchanged():
    """An exposure edit must add exactly 4 entries (basecurve..transform),
    same as the per-stage path — intermediates ARE cached by the fused
    dispatch, so a later deeper edit (gamma-only change via linear flag,
    say) still resumes from the deepest valid stage."""
    raw = synthetic_bayer(96, 72)
    p = Pipeline.new_from_source(ImageSource.from_raw(raw))
    cache = Pipeline.new_cache(200 << 20)
    p.output_8bit(cache)
    n0 = len(cache)
    p.ops.basecurve.exposure = 0.5
    p.output_8bit(cache)
    assert len(cache) == n0 + 4
    # Re-render with identical settings: pure cache hit, no new entries.
    p.output_8bit(cache)
    assert len(cache) == n0 + 4


def test_fused_suffix_spline_curve_edit():
    # Curve-point edits change n_knots (a trace static): consecutive edits
    # with different knot counts must stay bit-equal to the staged path.
    edits = [{"points": [(0.2, 0.3), (0.5, 0.6), (0.8, 0.85)]},
             {"points": [(0.5, 0.55)]}]
    fused, _ = _develop_with_edit(True, edits=edits)
    staged, _ = _develop_with_edit(False, edits=edits)
    for f, s in zip(fused, staged):
        np.testing.assert_array_equal(f, s)


def test_maximal_tail_fuses_past_declining_rotatecrop(monkeypatch):
    """An active crop (rotatecrop declines device_chain) must not drop the
    whole suffix to per-stage dispatch: the tolab->...->transform tail after
    it still fuses (VERDICT r4 weak #2), bit-equal to the staged path."""
    calls = []
    orig = plmod.Pipeline._dispatch_fused

    def spy(self, ops, startpos, chains, *a, **k):
        calls.append([op.name() for op in ops[startpos:startpos + len(chains)]])
        return orig(self, ops, startpos, chains, *a, **k)

    monkeypatch.setattr(plmod.Pipeline, "_dispatch_fused", spy)
    edits = [{"exposure": 0.25}]

    def dev(fuse):
        raw = synthetic_bayer(96, 72)
        old = plmod.FUSE_SUFFIX
        plmod.FUSE_SUFFIX = fuse
        try:
            p = Pipeline.new_from_source(ImageSource.from_raw(raw))
            p.ops.rotatecrop.crop_left = 0.1  # active crop: declines fusion
            cache = Pipeline.new_cache(200 << 20)
            outs = [np.array(p.output_8bit(cache).data)]
            for ed in edits:
                for k, v in ed.items():
                    setattr(p.ops.basecurve, k, v)
                outs.append(np.array(p.output_8bit(cache).data))
            return outs
        finally:
            plmod.FUSE_SUFFIX = old

    fused = dev(True)
    assert any(seg and seg[0] == "to_lab" for seg in calls), calls
    calls.clear()
    staged = dev(False)
    assert not calls
    for f, s in zip(fused, staged):
        np.testing.assert_array_equal(f, s)


def test_fused_dispatch_failure_falls_back_per_stage(monkeypatch):
    """A compile/dispatch error of the fused suffix must fall back to the
    proven per-stage path, not abort the render."""
    import jax

    boom = [0]
    orig_jit = jax.jit

    def bad_jit(fn, *a, **k):
        jitted = orig_jit(fn, *a, **k)

        def wrapper(*args, **kwargs):
            boom[0] += 1
            raise RuntimeError("fused suffix failed to compile")

        return wrapper

    raw = synthetic_bayer(96, 72)
    p = Pipeline.new_from_source(ImageSource.from_raw(raw))
    cache = Pipeline.new_cache(200 << 20)
    ref = np.array(p.output_8bit(cache).data)

    p2 = Pipeline.new_from_source(ImageSource.from_raw(raw))
    cache2 = Pipeline.new_cache(200 << 20)
    monkeypatch.setattr(jax, "jit", bad_jit)
    out = np.array(p2.output_8bit(cache2).data)
    assert boom[0] >= 1  # the fused dispatch was attempted and failed
    np.testing.assert_array_equal(out, ref)


def test_fused_quantize_is_single_dispatch_cached_edit():
    """After a warm cache, an exposure edit's output_8bit runs the suffix
    AND the quantize in one fused dispatch (quant returned non-None)."""
    raw = synthetic_bayer(96, 72)
    p = Pipeline.new_from_source(ImageSource.from_raw(raw))
    cache = Pipeline.new_cache(200 << 20)
    p.output_8bit(cache)
    p.ops.basecurve.exposure = 0.4
    buffer, quant = p._run_impl(cache, final_quant=8)
    assert quant is not None
    assert quant.shape[0] == 3 and str(quant.dtype) == "uint8"
