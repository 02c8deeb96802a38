"""Smoke test of the develop path on one NVIDIA GPU.

Drives the normal entry points at real sizes on the card and holds every
output to the repo's cross-path contract against the same engine on the CPU
backend of the same process, in 'lut' numerics (the engine the CPU tests pin
to tests/oracle.py and native/golden_develop.cc): at most 1 LSB at 8 and 16
bit, and at most 1% of samples differing.

Phases, in order:
  (a) batch    BatchEngine.develop_files over 8 seeded 24MP RGGB DNGs, 8-bit
  (b) thumb    Pipeline.output_8bit at maxwidth 1024 on 24MP (scaled path)
  (c) xtrans   26MP X-Trans, 8-bit
  (d) big      61MP (9568x6376) 16-bit linear, with the develop's
               compiled.memory_analysis()
  (e) fulldown 24MP -> 0.79x fulldown, 16-bit
  (f) editor   RenderService: one slider edit at 1024px through the stage
               cache, then a 5 degree rotatecrop render (gather resampler)
  (g) tests    pytest -m gpu

Usage:
  python chip_smoke.py               phases (a)-(g) on one card
  python chip_smoke.py --four-cards  phase (a) on a dp=4 and a 2x2 dp x sp
                                     mesh, each against the one-card output
  python chip_smoke.py --rehearse    the same phases at tiny sizes on the CPU
                                     (no card check; prints no result line)

The parent process stays off JAX: it runs the phases in one child and the
card-marked tests in a second child, one after the other, so only one
process holds the card at a time. The last line of a passing card run is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exit code is non-zero, with no result line, when any phase fails or no GPU
is found.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

FULL = dict(
    batch=(6000, 4000, 8), thumb=(6000, 4000, 1024), xtrans=(6240, 4168),
    big=(9568, 6376), fulldown=(6000, 4000, 4740), editor=(6000, 4000, 1024))
TINY = dict(
    batch=(96, 64, 3), thumb=(192, 128, 40), xtrans=(120, 96),
    big=(160, 120), fulldown=(96, 64, 76), editor=(192, 128, 64))

MAX_LSB = 1
MAX_FLIP = 0.01
CHILD_TIMEOUT_S = 900
TESTS_TIMEOUT_S = 240


# ---------------------------------------------------------------------------
# Child: the phases (imports JAX and the package)
# ---------------------------------------------------------------------------

def _compare(name, got, want):
    import numpy as np

    got = np.asarray(got)
    want = np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != reference "
                             f"{want.shape}")
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    lsb = int(diff.max()) if diff.size else 0
    flip = float((diff != 0).mean()) if diff.size else 0.0
    if lsb > MAX_LSB or flip > MAX_FLIP:
        worst = np.argwhere(diff > MAX_LSB)[:4].tolist()
        raise AssertionError(
            f"{name}: max {lsb} LSB, {flip:.6f} of samples differ (limits "
            f"{MAX_LSB} LSB, {MAX_FLIP}); samples over the limit at {worst}: "
            f"{[(int(got[tuple(w)]), int(want[tuple(w)])) for w in worst]}")
    return lsb, flip


class _Phases:
    def __init__(self, rehearse):
        import jax

        from imagepipe_tpu import runtime

        self.jax = jax
        self.cache_dir = runtime.enable_compile_cache()
        self.info = (runtime.device_info() if rehearse
                     else runtime.require_gpu())
        self.dev = jax.devices()[0]
        self.cpu = jax.devices("cpu")[0]
        print(f"# jax {jax.__version__}: platform={self.info['platform']} "
              f"device_kind={self.info['kind']} count={self.info['count']} "
              f"compile_cache={self.cache_dir}", flush=True)

    def peak_bytes(self):
        stats = self.dev.memory_stats() or {}
        return stats.get("peak_bytes_in_use", "not reported")

    def run(self, name, served, reference):
        """served() runs twice on the default device (first call includes
        compilation, second is warm); reference() runs on the CPU backend
        in 'lut' numerics. Prints one line per phase."""
        t0 = time.perf_counter()
        out = served()
        t1 = time.perf_counter()
        out = served()
        t2 = time.perf_counter()
        with self.jax.default_device(self.cpu):
            want = reference()
        t3 = time.perf_counter()
        results = out if isinstance(out, list) else [out]
        wants = want if isinstance(want, list) else [want]
        assert len(results) == len(wants), (name, len(results), len(wants))
        lsb = flip = 0
        for i, (g, w) in enumerate(zip(results, wants)):
            l_, f_ = _compare(f"{name}[{i}]", g, w)
            lsb, flip = max(lsb, l_), max(flip, f_)
        first, warm = t1 - t0, t2 - t1
        print(f"phase {name}: first_call_s={first:.3f} warm_wall_s={warm:.3f}"
              f" compile_s~{max(first - warm, 0.0):.3f}"
              f" peak_bytes_in_use={self.peak_bytes()}"
              f" outputs={len(results)}x{tuple(results[0].shape)}"
              f" max_lsb={lsb} flip_frac={flip:.7f}"
              f" reference_cpu_s={t3 - t2:.3f}", flush=True)


def _lut_plan(source, out_bits, maxwidth=0, maxheight=0):
    """The reference plan: same settings as the served path, 'lut'
    numerics (call under jax.default_device(cpu))."""
    from imagepipe_tpu import Pipeline
    from imagepipe_tpu.engine import make_develop_plan

    pipe = Pipeline.new_from_source(source)
    pipe.globals.settings.maxwidth = maxwidth
    pipe.globals.settings.maxheight = maxheight
    pipe.globals.settings.linear = out_bits == 16
    return make_develop_plan(pipe, out_bits=out_bits, numerics="lut")


def _reference_develop(raw, out_bits, maxwidth=0, maxheight=0):
    import numpy as np

    from imagepipe_tpu import ImageSource
    from imagepipe_tpu.engine import develop_fused, planar_to_hwc

    plan = _lut_plan(ImageSource.from_raw(raw), out_bits, maxwidth, maxheight)
    return planar_to_hwc(develop_fused(plan, np.asarray(raw.data)))


def _write_dngs(directory, width, height, n):
    from imagepipe_tpu.dng import write_dng
    from imagepipe_tpu.raw import synthetic_bayer

    paths = []
    for i in range(n):
        raw = synthetic_bayer(width, height, seed=100 + i)
        # Per-image calibration: every shot has its own white balance.
        raw.wb_coeffs = (2.1 + 0.05 * i, 1.0, 1.45 - 0.03 * i, float("nan"))
        path = os.path.join(directory, f"shot{i}.dng")
        write_dng(path, raw)
        paths.append(path)
    return paths


def _reference_files(paths, out_bits=8):
    from imagepipe_tpu.decode import decode_file

    return [_reference_develop(decode_file(p).raw, out_bits) for p in paths]


def phases_one_card(sizes, rehearse):
    import dataclasses

    from imagepipe_tpu import ImageSource, Pipeline
    from imagepipe_tpu import color as cc
    from imagepipe_tpu.parallel import BatchEngine
    from imagepipe_tpu.raw import synthetic_bayer, synthetic_xtrans
    from imagepipe_tpu.service import RenderService

    ph = _Phases(rehearse)

    # (a) batch develop from DNG files.
    w, h, n = sizes["batch"]
    with tempfile.TemporaryDirectory() as td:
        paths = _write_dngs(td, w, h, n)
        engine = BatchEngine(max_batch=8)
        ph.run("a_batch_dng_8bit",
               lambda: engine.develop_files(paths),
               lambda: _reference_files(paths))

    def pipeline_out(raw, bits, maxwidth=0):
        pipe = Pipeline.new_from_source(ImageSource.from_raw(raw))
        pipe.globals.settings.maxwidth = maxwidth
        pipe.globals.settings.maxheight = maxwidth
        out = pipe.output_8bit() if bits == 8 else pipe.output_16bit()
        return out.data

    # (b) thumbnail through the scaled demosaic.
    w, h, mw = sizes["thumb"]
    raw = synthetic_bayer(w, h, seed=3)
    ph.run("b_thumbnail_8bit", lambda: pipeline_out(raw, 8, mw),
           lambda: _reference_develop(raw, 8, mw, mw))

    # (c) X-Trans, full size.
    w, h = sizes["xtrans"]
    raw = synthetic_xtrans(w, h, seed=4)
    ph.run("c_xtrans_8bit", lambda: pipeline_out(raw, 8),
           lambda: _reference_develop(raw, 8))

    # (d) big frame, 16-bit linear.
    w, h = sizes["big"]
    raw = synthetic_bayer(w, h, seed=5)
    _print_memory_analysis(raw)
    ph.run("d_bigframe_16bit", lambda: pipeline_out(raw, 16),
           lambda: _reference_develop(raw, 16))
    del raw

    # (e) fulldown, 16-bit.
    w, h, mw = sizes["fulldown"]
    raw = synthetic_bayer(w, h, seed=6)
    ph.run("e_fulldown_16bit", lambda: pipeline_out(raw, 16, mw),
           lambda: _reference_develop(raw, 16, mw, mw))

    # (f) editor session: slider edit then rotatecrop, 1024px previews.
    w, h, size = sizes["editor"]
    raw = synthetic_bayer(w, h, seed=7)
    edits = [{"basecurve": {"exposure": 0.3}},
             {"rotatecrop": {"rotation": 5.0 / 90.0}}]

    def session_renders():
        svc = RenderService(cache_bytes=4 << 30)
        svc.open_source("img", ImageSource.from_raw(raw))
        svc.render("img", max_size=size)
        return [svc.edit("img", e, max_size=size).data for e in edits]

    def reference_renders():
        mode = cc.get_numerics_mode()
        cc.set_numerics_mode("lut")
        try:
            svc = RenderService(cache_bytes=4 << 30)
            # A fresh RawImage: the served session cached its device plane
            # on `raw`, and the reference must upload to the CPU.
            svc.open_source("img", ImageSource.from_raw(
                dataclasses.replace(raw)))
            return [svc.edit("img", e, max_size=size).data for e in edits]
        finally:
            cc.set_numerics_mode(mode)

    ph.run("f_editor_edit_then_rotate", session_renders, reference_renders)
    return ph.info


def _print_memory_analysis(raw):
    """compiled.memory_analysis() of the jit develop_fused runs for this
    frame (one band's program when the frame is banded)."""
    import jax

    from imagepipe_tpu import ImageSource, Pipeline
    from imagepipe_tpu.engine import (_develop_single_jit, auto_bands,
                                      make_develop_plan)

    pipe = Pipeline.new_from_source(ImageSource.from_raw(raw))
    pipe.globals.settings.linear = True
    plan = make_develop_plan(pipe, out_bits=16)
    bands = auto_bands(plan)
    plane = jax.ShapeDtypeStruct(raw.data.shape, raw.data.dtype)
    t0 = time.perf_counter()
    compiled = _develop_single_jit.lower(
        plane, plan.params, **plan.statics()).compile()
    print(f"# d_bigframe develop: auto_bands={bands} "
          f"numerics={plan.numerics} plane={plane.shape} compile_s="
          f"{time.perf_counter() - t0:.3f} unbanded memory_analysis: "
          f"{compiled.memory_analysis()}", flush=True)


def phase_four_cards(sizes, rehearse):
    import jax

    from imagepipe_tpu.parallel import BatchEngine, make_batch_mesh

    ph = _Phases(rehearse)
    devs = jax.devices()
    if len(devs) < 4:
        raise SystemExit(f"--four-cards needs 4 devices, JAX sees {len(devs)}")
    devs = devs[:4]
    w, h, n = sizes["batch"]
    with tempfile.TemporaryDirectory() as td:
        paths = _write_dngs(td, w, h, n)
        one = BatchEngine(mesh=make_batch_mesh(devs[:1]), max_batch=8)
        t0 = time.perf_counter()
        want = one.develop_files(paths)
        print(f"# one-card reference: {time.perf_counter() - t0:.3f}s "
              f"(first call)", flush=True)
        for label, spatial in (("dp4", 1), ("dp2xsp2", 2)):
            eng = BatchEngine(mesh=make_batch_mesh(devs, spatial=spatial),
                              max_batch=8)
            t0 = time.perf_counter()
            got = eng.develop_files(paths)
            t1 = time.perf_counter()
            got = eng.develop_files(paths)
            t2 = time.perf_counter()
            lsb = flip = 0
            for i, (g, w_) in enumerate(zip(got, want)):
                l_, f_ = _compare(f"{label}[{i}]", g, w_)
                lsb, flip = max(lsb, l_), max(flip, f_)
            print(f"phase a_batch_{label}: mesh={dict(eng.mesh.shape)} "
                  f"first_call_s={t1 - t0:.3f} warm_wall_s={t2 - t1:.3f} "
                  f"max_lsb={lsb} flip_frac={flip:.7f} vs one card",
                  flush=True)
    info = dict(ph.info)
    info["count"] = len(devs)
    return info


def child_main(mode, rehearse):
    sizes = TINY if rehearse else FULL
    if mode == "four-cards":
        info = phase_four_cards(sizes, rehearse)
    else:
        info = phases_one_card(sizes, rehearse)
    print("CHILD_RESULT " + json.dumps(info), flush=True)
    return 0


# ---------------------------------------------------------------------------
# Parent: stays off JAX, runs the children one after the other
# ---------------------------------------------------------------------------

def _run(cmd, env, timeout_s):
    """Run a child, echo its output, return (rc, stdout text)."""
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                           text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired as e:
        sys.stdout.write(e.stdout or "" if isinstance(e.stdout, str) else "")
        print(f"# child timed out after {timeout_s}s: {' '.join(cmd)}")
        return 124, ""
    sys.stdout.write(r.stdout)
    if r.returncode != 0:
        sys.stdout.write(r.stderr[-6000:])
    print(f"# child rc={r.returncode} in {time.perf_counter() - t0:.1f}s: "
          f"{' '.join(cmd[1:])}", flush=True)
    return r.returncode, r.stdout


def _card_tests(env, rehearse):
    """(g): the card-marked tests, in their own process. On the card every
    selected test must pass: a skip there means the card was not reached."""
    xml = os.path.join(tempfile.mkdtemp(), "gpu_tests.xml")
    env = dict(env)
    if not rehearse:
        env["JAX_PLATFORMS"] = "cuda,cpu"
    cmd = [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "tests/",
           "-p", "no:cacheprovider", f"--junitxml={xml}"]
    rc, _ = _run(cmd, env, TESTS_TIMEOUT_S)
    if rc != 0:
        return False
    import xml.etree.ElementTree as ET

    suite = ET.parse(xml).getroot()
    suite = suite if suite.tag == "testsuite" else suite.find("testsuite")
    counts = {k: int(suite.get(k, 0)) for k in
              ("tests", "failures", "errors", "skipped")}
    print(f"phase g_card_tests: {counts}", flush=True)
    if rehearse:
        return counts["failures"] == counts["errors"] == 0
    return (counts["tests"] > 0 and counts["skipped"] == 0
            and counts["failures"] == counts["errors"] == 0)


def main(argv):
    rehearse = "--rehearse" in argv
    if "--child" in argv:
        return child_main(argv[argv.index("--child") + 1], rehearse)

    mode = "four-cards" if "--four-cards" in argv else "one-card"
    from_repo = os.path.isdir(os.path.join(REPO, "imagepipe_tpu"))
    card = _card_line()
    print(f"# card: {card}", flush=True)
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    # The CPU reference compiles with XLA:CPU's legacy loop emitters: with
    # the default fusion emitters, the 'lut' develop of a few samples per
    # 24MP frame lands a LUT step away from the value every other program
    # gives (PERF.md, bring-up findings). The flag touches CPU compiles only.
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_cpu_use_fusion_emitters=false").strip()
    platforms = env.get("JAX_PLATFORMS", "")
    if platforms and "cpu" not in platforms.split(","):
        # The CPU reference runs in the same process as the card.
        env["JAX_PLATFORMS"] = platforms + ",cpu"
    if rehearse:
        env["JAX_PLATFORMS"] = "cpu"
        if mode == "four-cards":
            env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                                " --xla_force_host_platform_device_count=4")
    cmd = [sys.executable, os.path.abspath(__file__), "--child", mode]
    if rehearse:
        cmd.append("--rehearse")
    rc, out = _run(cmd, env, CHILD_TIMEOUT_S)
    result = [l for l in out.splitlines() if l.startswith("CHILD_RESULT ")]
    if rc != 0 or not result or not from_repo:
        print("# FAILED: phase child", flush=True)
        return 1
    info = json.loads(result[-1][len("CHILD_RESULT "):])
    if mode == "one-card" and not _card_tests(env, rehearse):
        print("# FAILED: g_card_tests", flush=True)
        return 1
    if rehearse:
        print("# rehearsal passed (CPU, tiny sizes): not a card result")
        return 0
    if info.get("platform") != "gpu":
        print(f"# FAILED: not a GPU: {info}", flush=True)
        return 1
    print(f"# card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


def _card_line():
    import shutil

    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi not found"
    r = subprocess.run([exe, "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return (r.stdout.strip() or r.stderr.strip()).replace("\n", " | ")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
