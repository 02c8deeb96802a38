"""A/B of the three backend-dependent defaults on the card.

  numerics  'lut' vs 'direct' on the 24MP Bayer 8-bit develop (batch 8,
            per-image calibration, the BatchEngine program) and on the
            24MP -> 1024px thumbnail develop
  unroll    static unroll vs fori of the aligned resampler on the
            24MP -> 0.79x fulldown (4-plane f32 input, 4740x3160 output)
  banding   the unbanded 61MP 16-bit develop: compiled.memory_analysis(),
            peak_bytes_in_use, and its time against bands=4
  contract  each numerics mode on the card against the CPU 'lut' reference
            (and CPU 'direct' against CPU 'lut') on a 24MP frame at 8 and
            16 bit: max LSB, flip fraction, and the worst samples

Times are host wall clock around calls that end in block_until_ready, in
interleaved reps (A, B, B, A, ...) after a warm-up call of each variant.
Prints one line per measurement; needs a GPU (`--rehearse` runs the same
code at tiny sizes on any backend, for checking the script itself).

    python scripts/gpu_defaults_ab.py [banding] [numerics] [unroll] [contract]

With no section named, all four run.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from imagepipe_tpu import ImageSource, Pipeline, runtime  # noqa: E402
from imagepipe_tpu.engine import (  # noqa: E402
    _develop_batch_perimage_jit, _develop_single_jit, develop_fused,
    make_develop_plan, stack_params)
from imagepipe_tpu.raw import synthetic_bayer  # noqa: E402
from imagepipe_tpu import scaling  # noqa: E402

REPS = 3
ITERS = 10
REHEARSE = "--rehearse" in sys.argv
BIG = (160, 120) if REHEARSE else (9568, 6376)
FRAME = (192, 128) if REHEARSE else (6000, 4000)
THUMB = 40 if REHEARSE else 1024


def _time(fn, iters=ITERS):
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def ab(label, variants, iters=ITERS):
    """variants: {name: fn}. Warm each, then REPS rounds of A,B,B,A."""
    for fn in variants.values():
        jax.block_until_ready(fn())
    names = list(variants)
    samples = {n: [] for n in names}
    for r in range(REPS):
        order = names if r % 2 == 0 else names[::-1]
        for n in order + order[::-1]:
            samples[n].append(_time(variants[n], iters) * 1e3)
    for n in names:
        s = sorted(samples[n])
        print(f"ab {label} {n}: ms median={s[len(s) // 2]:.3f} "
              f"min={s[0]:.3f} max={s[-1]:.3f} n={len(s)}", flush=True)


def peak():
    return (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")


def banding():
    raw = synthetic_bayer(*BIG, seed=5)
    pipe = Pipeline.new_from_source(ImageSource.from_raw(raw))
    pipe.globals.settings.linear = True
    plan = make_develop_plan(pipe, out_bits=16)
    plane = jax.device_put(raw.data)
    before = peak()
    compiled = _develop_single_jit.lower(
        plane, plan.params, **plan.statics()).compile()
    print(f"banding 61MP unbanded numerics={plan.numerics} "
          f"memory_analysis: {compiled.memory_analysis()}", flush=True)
    jax.block_until_ready(develop_fused(plan, plane, bands=1))
    print(f"banding 61MP unbanded peak_bytes_in_use before={before} "
          f"after={peak()} bytes_limit="
          f"{(jax.devices()[0].memory_stats() or {}).get('bytes_limit')} "
          f"px={raw.width * raw.height}", flush=True)
    ab("banding_61MP_16bit", {
        "bands1": lambda: develop_fused(plan, plane, bands=1),
        "bands4": lambda: develop_fused(plan, plane, bands=4)}, iters=5)


def numerics():
    raws = [synthetic_bayer(*FRAME, seed=s) for s in range(2)]
    planes = jax.device_put(np.stack([raws[i % 2].data for i in range(8)]))
    variants = {}
    tvariants = {}
    for mode in ("lut", "direct"):
        plans = []
        for i in range(8):
            pipe = Pipeline.new_from_source(ImageSource.from_raw(raws[i % 2]))
            plans.append(make_develop_plan(pipe, out_bits=8, numerics=mode))
        params = stack_params([p.params for p in plans])
        st = plans[0].statics()
        variants[mode] = (lambda params=params, st=st:
                          _develop_batch_perimage_jit(planes, params, **st))
        tp = Pipeline.new_from_source(ImageSource.from_raw(raws[0]))
        tp.globals.settings.maxwidth = tp.globals.settings.maxheight = THUMB
        tplan = make_develop_plan(tp, out_bits=8, numerics=mode)
        tvariants[mode] = (lambda tplan=tplan:
                           develop_fused(tplan, planes[0]))
    ab("numerics_24MP_batch8_8bit", variants, iters=5)
    ab("numerics_24MP_thumb1024_8bit", tvariants)


def unroll():
    rng = np.random.default_rng(1)
    w, h = FRAME
    nw, nh = round(w * 0.79), round(h * 0.79)
    src = jax.device_put(rng.random((4, h, w), dtype=np.float32))
    tile = jnp.zeros((48, 48), jnp.uint8)
    kw = dict(width=w, height=h, topleft=(0, 0), topright=(w - 1, 0),
              bottomleft=(0, h - 1), nwidth=nw, nheight=nh, components=4,
              cfa_key=None, out_dtype=jnp.float32, planar=True)
    f = {u: (lambda u=u: scaling._transform_aligned_impl(
        src, tile, unroll=u, **kw)) for u in (True, False)}
    a, b = np.asarray(f[True]()), np.asarray(f[False]())
    print(f"unroll outputs max abs diff {np.abs(a - b).max():.3e}", flush=True)
    ab("unroll_24MP_fulldown_0.79x", {"unrolled": f[True], "fori": f[False]})


def _develop(raw, out_bits, numerics, device):
    from imagepipe_tpu.engine import planar_to_hwc

    with jax.default_device(device):
        pipe = Pipeline.new_from_source(ImageSource.from_raw(raw))
        pipe.globals.settings.linear = out_bits == 16
        plan = make_develop_plan(pipe, out_bits=out_bits, numerics=numerics)
        return planar_to_hwc(develop_fused(plan, np.asarray(raw.data)))


def contract():
    raw = synthetic_bayer(*FRAME, seed=100)
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    for bits in (8, 16):
        ref = _develop(raw, bits, "lut", cpu).astype(np.int64)
        for label, mode, dev in (("card_lut", "lut", gpu),
                                 ("card_direct", "direct", gpu),
                                 ("cpu_direct", "direct", cpu)):
            got = _develop(raw, bits, mode, dev).astype(np.int64)
            diff = np.abs(got - ref)
            worst = np.argwhere(diff > 1)[:4].tolist()
            print(f"contract {bits}bit {label} vs cpu_lut: "
                  f"max_lsb={diff.max()} flip_frac={(diff != 0).mean():.7f} "
                  f"n_over_1={(diff > 1).sum()} worst={worst} "
                  f"values={[(int(got[tuple(w)]), int(ref[tuple(w)])) for w in worst]}",
                  flush=True)


def main():
    runtime.enable_compile_cache()
    info = runtime.device_info() if REHEARSE else runtime.require_gpu()
    print(f"# {info}", flush=True)
    sections = [a for a in sys.argv[1:] if not a.startswith("--")]
    sections = sections or ["banding", "numerics", "unroll", "contract"]
    for name in sections:   # banding first: its peak is then its own
        globals()[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
