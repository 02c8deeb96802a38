"""The GPU bring-up rules, checked on the CPU: no Mosaic kernel is left,
selection matmuls are exact, no executor choice depends on the backend
name, the compile cache follows its rule, the develop's banding follows the
device's own memory limit, and chip_smoke.py refuses to pass without a GPU.
"""

import ast
import functools
import os
import re
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from imagepipe_tpu import ImageSource, Pipeline, runtime, scaling
from imagepipe_tpu import color as cc
from imagepipe_tpu.engine import (DEVELOP_BYTES_PER_PX, auto_bands,
                                  develop_fused, make_develop_plan)
from imagepipe_tpu.parallel import BatchEngine
from imagepipe_tpu.raw import CFA, synthetic_bayer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "imagepipe_tpu")


def _py_files(*roots):
    for root in roots:
        if root.endswith(".py"):
            yield root
            continue
        for d, _, files in os.walk(root):
            for f in files:
                if f.endswith(".py"):
                    yield os.path.join(d, f)


# The Mosaic Pallas module of the old accelerator, spelled in pieces so
# this file does not match its own search.
_MOSAIC = "tp" + "u"


def test_no_source_imports_mosaic_pallas():
    pat = re.compile(rf"pallas\.{_MOSAIC}|pallas import {_MOSAIC}|pl{_MOSAIC}")
    hits = []
    for path in _py_files(PACKAGE, os.path.join(REPO, "scripts"),
                          os.path.join(REPO, "tests"),
                          os.path.join(REPO, "bench.py"),
                          os.path.join(REPO, "chip_smoke.py"),
                          os.path.join(REPO, "__graft_entry__.py")):
        with open(path, encoding="utf-8") as f:
            if pat.search(f.read()):
                hits.append(os.path.relpath(path, REPO))
    assert not hits, hits


def test_importing_every_module_loads_no_pallas():
    code = (
        "import importlib, pkgutil, sys\n"
        "import imagepipe_tpu\n"
        "for m in pkgutil.walk_packages(imagepipe_tpu.__path__, 'imagepipe_tpu.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.startswith('jax.experimental.pallas')]\n"
        "print('BAD', bad)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "BAD []" in r.stdout, r.stdout


def _dot_precisions(jaxpr):
    """Precision params of every dot_general in a (closed) jaxpr, nested
    jaxprs included."""
    found = []

    def walk(j):
        for eqn in j.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                    if hasattr(sub, "eqns"):
                        walk(sub)
                    elif hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                        walk(sub.jaxpr)

    walk(jaxpr.jaxpr)
    return found


def _is_highest(p):
    ps = p if isinstance(p, tuple) else (p,)
    return all(q == jax.lax.Precision.HIGHEST for q in ps)


@pytest.mark.parametrize("banded", [True, False])
@pytest.mark.parametrize("cfa_name", [None, "RGGB"])
def test_selection_dot_generals_are_highest(banded, cfa_name):
    """The one-hot selection matmuls carry HIGHEST: exact f32 selection on
    every backend (HIGH is TF32 on the GPU)."""
    w, h, nw, nh = 520, 40, 384, 30
    C = 1 if cfa_name else 4
    tile, key = scaling._cfa_args(CFA(cfa_name) if cfa_name else None)
    fn = functools.partial(
        scaling._transform_aligned_impl, width=w, height=h, topleft=(0, 0),
        topright=(w - 1, 0), bottomleft=(0, h - 1), nwidth=nw, nheight=nh,
        components=4, cfa_key=key, out_dtype=jnp.float32, planar=True,
        banded=banded, unroll=False)
    jaxpr = jax.make_jaxpr(fn)(jnp.zeros((C, h, w), jnp.float32), tile)
    precs = _dot_precisions(jaxpr)
    assert precs, "no selection matmul traced"
    assert all(_is_highest(p) for p in precs), precs


def test_thumbnail_develop_dot_generals_are_highest():
    raw = synthetic_bayer(480, 320, seed=1)
    p = Pipeline.new_from_source(ImageSource.from_raw(raw))
    p.globals.settings.maxwidth = p.globals.settings.maxheight = 96
    plan = make_develop_plan(p, out_bits=16)
    assert plan.dem_path == "scaled"
    jaxpr = jax.make_jaxpr(lambda x: develop_fused(plan, x))(
        jnp.zeros(raw.data.shape, raw.data.dtype))
    precs = _dot_precisions(jaxpr)
    assert precs and all(_is_highest(p) for p in precs), precs


def test_backend_name_only_in_measured_defaults():
    """Only the two card-measured defaults read the backend name, and each
    cites its measurement in PERF.md."""
    sites = []
    for path in _py_files(PACKAGE):
        with open(path, encoding="utf-8") as f:
            src = f.read()
        for node in ast.walk(ast.parse(src)):
            if isinstance(node, ast.FunctionDef):
                body = ast.get_source_segment(src, node) or ""
                if "default_backend()" in body:
                    sites.append((os.path.relpath(path, PACKAGE), node.name,
                                  "PERF.md" in body or "PERF.md" in src))
    names = sorted(s[:2] for s in sites)
    assert names == [("color.py", "default_numerics"),
                     ("scaling.py", "_transform_aligned_impl")], names
    assert all(s[2] for s in sites), sites


def test_batch_engine_has_one_executor():
    import inspect

    params = inspect.signature(BatchEngine.__init__).parameters
    assert "executor" not in params
    assert not hasattr(BatchEngine, "_use_pallas")
    kernels = sorted(f for f in os.listdir(os.path.join(PACKAGE, "kernels"))
                     if f.endswith(".py"))
    assert kernels == ["__init__.py", "demosaic_full.py"], kernels


def test_default_numerics_on_cpu():
    assert jax.default_backend() == "cpu"
    assert cc.default_numerics() == "lut"
    assert cc.GPU_NUMERICS in ("lut", "direct")


def test_compile_cache_dir_env_is_honoured():
    path, set_in_code = runtime.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/some/cache"})
    assert (path, set_in_code) == ("/some/cache", False)


def test_compile_cache_dir_defaults_to_ignored_checkout_path():
    path, set_in_code = runtime.compile_cache_dir({})
    assert set_in_code
    assert os.path.dirname(path) == REPO
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert os.path.basename(path) + "/" in f.read().split()


@pytest.mark.parametrize("env_dir", [None, "cache_from_env"])
def test_enable_compile_cache_in_a_process(tmp_path, env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    code = ("import jax\nfrom imagepipe_tpu import runtime\n"
            "print('RET', runtime.enable_compile_cache())\n"
            "print('CFG', jax.config.jax_compilation_cache_dir)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    want = str(tmp_path / env_dir) if env_dir else runtime.CHECKOUT_CACHE_DIR
    assert f"RET {want}" in r.stdout and f"CFG {want}" in r.stdout, r.stdout


class _Dev:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats,want", [
    (None, 1),                                  # the CPU reports no limit
    ({"bytes_limit": 60 << 30}, 1),             # 61MP fits an 80 GB card
    ({"bytes_limit": 1 << 30}, None),           # a small device bands
])
def test_auto_bands_follow_device_limit(stats, want):
    raw = synthetic_bayer(96, 64)
    plan = make_develop_plan(Pipeline.new_from_source(
        ImageSource.from_raw(raw)), out_bits=16)
    plan.height, plan.width = 6376, 9568
    got = auto_bands(plan, _Dev(stats))
    if want is None:
        need = 6376 * 9568 * DEVELOP_BYTES_PER_PX
        assert got == -(-need // ((1 << 30) // 2))
        assert got > 1
    else:
        assert got == want


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_chip_smoke_fails_without_gpu():
    r = _run_smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stdout + r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_orientation_is_a_pure_permutation_at_16bit():
    """Transposed EXIF orientations permute the quantized planes: the fused
    16-bit develop equals the Normal develop transposed, sample for sample
    (a transpose fused into the arithmetic used to move samples by tens of
    LSB)."""
    from imagepipe_tpu.engine import planar_to_hwc
    from imagepipe_tpu.raw import Orientation

    raw = synthetic_bayer(168, 112, seed=1)

    def develop(orient):
        raw.orientation = Orientation(orient)
        p = Pipeline.new_from_source(ImageSource.from_raw(raw))
        p.globals.settings.linear = True
        plan = make_develop_plan(p, out_bits=16)
        return (planar_to_hwc(develop_fused(plan, raw.data)),
                plan.orientation_flips)

    normal, _ = develop("Normal")
    for orient in ("Transpose", "Rotate90", "Transverse", "Rotate270"):
        got, (transpose, flip_x, flip_y) = develop(orient)
        want = normal[:, ::-1] if flip_x else normal
        want = want[::-1] if flip_y else want
        want = want.transpose(1, 0, 2) if transpose else want
        np.testing.assert_array_equal(got, want, err_msg=orient)
