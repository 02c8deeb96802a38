"""Profiling helpers.

The reference instruments per-stage wall time with the do_timing! macro
(/root/reference/src/pipeline.rs:68-80; SURVEY.md section 5 notes those logs
are wrong under async device dispatch). Here:

  * per-stage wall logs come from pipeline._timing (same log line format);
  * device-accurate traces come from jax.profiler via `trace(...)` below --
    open the dump in TensorBoard / Perfetto;
  * `timed_sync(fn)` measures calls that end in `block_until_ready`.
"""

from __future__ import annotations

import contextlib
import time

import jax

__all__ = ["trace", "timed_sync", "vpu_pass_census"]


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace scope: with profiling.trace('/tmp/trace'): ..."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def timed_sync(fn, *args, iters: int = 1, **kwargs):
    """(result, seconds_per_iter): one warm-up call, then `iters` calls
    timed up to `block_until_ready` of the last result."""
    out = jax.block_until_ready(fn(*args, **kwargs))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    jax.block_until_ready(out)
    return out, (time.perf_counter() - t0) / iters


# -- Elementwise pass census ------------------------------------------------
#
# Counts the develop chain's elementwise work per output pixel by walking
# the jaxpr of the XLA fused engine, bucketing primitives into plain f32
# passes, exp/log-class passes, dot elements and gather-class elements.
# It runs on the host only and says what the chain computes, not how fast.

_CHEAP_PRIMS = frozenset((
    "add", "sub", "mul", "div", "max", "min", "and", "or", "xor", "not",
    "neg", "abs", "sign", "floor", "ceil", "round", "select_n", "clamp",
    "eq", "ne", "lt", "le", "gt", "ge", "integer_pow", "pow",
    "convert_element_type", "nextafter", "rem", "shift_right_logical",
    "shift_left", "shift_right_arithmetic", "iota", "tile", "where",
))
_TRANSCENDENTAL_PRIMS = frozenset((
    "exp", "log", "exp2", "log2", "log1p", "expm1", "cbrt", "sqrt",
    "rsqrt", "tanh", "logistic", "erf", "sin", "cos",
))
_MOVEMENT_PRIMS = frozenset((
    "broadcast_in_dim", "reshape", "squeeze", "slice", "dynamic_slice",
    "dynamic_update_slice", "concatenate", "pad", "transpose", "rev",
    "copy", "convert_layout", "reduce_sum", "reduce_max", "reduce_min",
    "expand_dims", "stop_gradient", "optimization_barrier", "real",
    "reduce_and", "reduce_or", "squeeze", "split",
))


def _walk_jaxpr(jaxpr, counts):
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        sub = None
        for v in eqn.params.values():
            # closed_call / pjit / custom_jvp carry inner jaxprs.
            if hasattr(v, "jaxpr"):
                sub = v.jaxpr if hasattr(v.jaxpr, "eqns") else v
            elif hasattr(v, "eqns"):
                sub = v
            if sub is not None:
                _walk_jaxpr(sub if hasattr(sub, "eqns") else sub.jaxpr,
                            counts)
                sub = None
        elems = 0
        for ov in eqn.outvars:
            shape = getattr(getattr(ov, "aval", None), "shape", None)
            if shape is not None:
                n = 1
                for d in shape:
                    n *= int(d)
                elems = max(elems, n)
        if name in _TRANSCENDENTAL_PRIMS:
            counts["transcendental"] += elems
            counts["by_prim"][name] = counts["by_prim"].get(name, 0) + elems
        elif name in _CHEAP_PRIMS:
            counts["cheap"] += elems
        elif name == "dot_general":
            counts["mxu"] += elems
        elif name in ("gather", "take", "scatter", "sort", "argsort"):
            counts["serialized"] += elems
        elif name not in _MOVEMENT_PRIMS and name not in (
                "jit", "pjit", "closed_call", "core_call", "remat",
                "checkpoint", "custom_jvp_call", "custom_vjp_call",
                "cond", "while", "scan", "custom_jvp_call_jaxpr"):
            # call primitives were already descended into above
            counts["other"][name] = counts["other"].get(name, 0) + elems
    return counts


def vpu_pass_census(plan, plane_shape=None):
    """Count the fused develop chain's elementwise element-passes per
    OUTPUT pixel. Returns a dict with per-pixel 'cheap' (plain f32 pass
    elements), 'transcendental' (exp/log-class elements), 'mxu' (dot
    elements), 'serialized' (gather-class -- 0 in direct mode), plus raw
    totals. Traces on the host only (no device)."""
    import jax.numpy as jnp

    from . import engine as _engine

    if plane_shape is None:
        plane_shape = (plan.height, plan.width)
    spec = jax.ShapeDtypeStruct(plane_shape, jnp.float32)
    jaxpr = jax.make_jaxpr(
        lambda p: _engine.develop_fused(plan, p))(spec)
    counts = {"cheap": 0, "transcendental": 0, "mxu": 0, "serialized": 0,
              "by_prim": {}, "other": {}}
    _walk_jaxpr(jaxpr.jaxpr, counts)
    n_px = float((plan.dem_w * plan.dem_h) or (plan.width * plan.height))
    return {
        "per_px_cheap": counts["cheap"] / n_px,
        "per_px_transcendental": counts["transcendental"] / n_px,
        "per_px_mxu": counts["mxu"] / n_px,
        "per_px_serialized": counts["serialized"] / n_px,
        "totals": {k: counts[k] for k in
                   ("cheap", "transcendental", "mxu", "serialized")},
        "transcendental_by_prim": counts["by_prim"],
        "unclassified": counts["other"],
        "n_px": n_px,
    }
