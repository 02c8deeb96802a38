"""Card-marked tests: the develop paths on the GPU against the same engine on
the CPU backend in 'lut' numerics (the engine the CPU tests pin to the
oracles), held to the cross-path contract: <=1 LSB, <1% of samples.

They skip without a GPU. On the card:
    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from imagepipe_tpu import ImageSource, Pipeline
from imagepipe_tpu.engine import develop_fused, make_develop_plan, planar_to_hwc
from imagepipe_tpu.raw import synthetic_bayer, synthetic_mono, synthetic_xtrans

pytestmark = pytest.mark.gpu


def _contract(got, want):
    diff = np.abs(np.asarray(got).astype(np.int64)
                  - np.asarray(want).astype(np.int64))
    assert diff.max() <= 1, diff.max()
    assert (diff != 0).mean() < 0.01


def _plan(raw, out_bits, maxwidth=0, numerics="auto"):
    p = Pipeline.new_from_source(ImageSource.from_raw(raw))
    p.globals.settings.maxwidth = maxwidth
    p.globals.settings.maxheight = maxwidth
    p.globals.settings.linear = out_bits == 16
    return make_develop_plan(p, out_bits=out_bits, numerics=numerics)


def _reference(raw, out_bits, maxwidth=0):
    with jax.default_device(jax.devices("cpu")[0]):
        plan = _plan(raw, out_bits, maxwidth, numerics="lut")
        return planar_to_hwc(develop_fused(plan, np.asarray(raw.data)))


def test_selection_matmul_exact_on_gpu(gpu):
    """One-hot selection at HIGHEST returns the selected f32 values
    bit-exactly on the card (TF32 would keep 10 mantissa bits)."""
    rng = np.random.default_rng(0)
    a = rng.uniform(0.0, 65535.0, (256, 512)).astype(np.float32)
    idx = rng.integers(0, 512, 300)
    onehot = (np.arange(512)[None, :] == idx[:, None]).astype(np.float32)
    sel = jax.jit(lambda x, p: jax.lax.dot_general(
        x, p, (((1,), (1,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST))(
        jax.device_put(a, gpu), jax.device_put(onehot, gpu))
    np.testing.assert_array_equal(np.asarray(sel), a[:, idx])


@pytest.mark.parametrize("make_raw,out_bits,maxwidth", [
    (synthetic_bayer, 8, 0),
    (synthetic_bayer, 16, 0),
    (synthetic_xtrans, 8, 0),
    (synthetic_mono, 16, 0),
    (synthetic_bayer, 8, 160),     # scaled thumbnail
    (synthetic_bayer, 16, 160),
    (synthetic_bayer, 16, 480),    # fulldown
])
def test_develop_matches_cpu_reference(gpu, make_raw, out_bits, maxwidth):
    raw = make_raw(612, 408, seed=21)
    plan = _plan(raw, out_bits, maxwidth)
    got = planar_to_hwc(develop_fused(plan, jax.device_put(raw.data, gpu)))
    _contract(got, _reference(raw, out_bits, maxwidth))


def test_batch_engine_on_gpu(gpu):
    from imagepipe_tpu.parallel import BatchEngine

    raws = [synthetic_bayer(612, 408, seed=30 + s) for s in range(3)]
    raws[1].wb_coeffs = (1.0, 1.0, 2.8, float("nan"))
    outs = BatchEngine(max_batch=4).develop_sources(
        [ImageSource.from_raw(r) for r in raws])
    for raw, out in zip(raws, outs):
        _contract(out, _reference(raw, 8))


def test_rotatecrop_gather_on_gpu(gpu):
    """The staged editor path with a free rotation (gather resampler)."""
    from imagepipe_tpu import color as cc
    from imagepipe_tpu.service import RenderService

    raw = synthetic_bayer(612, 408, seed=40)
    patch = {"rotatecrop": {"rotation": 5.0 / 90.0}}
    svc = RenderService()
    svc.open_source("img", ImageSource.from_raw(raw))
    got = svc.edit("img", patch, max_size=256).data
    mode = cc.get_numerics_mode()
    cc.set_numerics_mode("lut")
    try:
        with jax.default_device(jax.devices("cpu")[0]):
            ref = RenderService()
            ref.open_source("img", ImageSource.from_raw(dataclasses.replace(raw)))
            want = ref.edit("img", patch, max_size=256).data
    finally:
        cc.set_numerics_mode(mode)
    _contract(got, want)


def test_default_device_is_the_card(gpu):
    """Arrays land on the card and the numerics default resolves for it."""
    from imagepipe_tpu import color as cc

    assert jnp.zeros(3).devices() == {gpu}
    assert cc.default_numerics() == cc.GPU_NUMERICS
