"""Interleaved A/B of the native decoders: HEAD (old bit reader) vs the
working tree (shared cached 64-bit reader, lj92 Huffman LUT).

Builds the old sources from `git show HEAD:native/*.cc` into a separate
shared library, then calls both libraries' C entry points directly with
identical payloads, interleaving A/B reps so host noise hits both sides.
Run on a quiet host (no pytest / bench in parallel).
"""

import ctypes
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
NEW_SO = os.path.join(REPO, "native", "build", "libimagepipe_host.so")
SRCS = ["nikon.cc", "olympus.cc", "pentax.cc", "lj92.cc"]
# The last commit with the per-peek byte-loop readers (the "old" side).
REF = os.environ.get("DECODE_AB_REF", "782afdc")


def build_old(tmp):
    for name in SRCS:
        src = subprocess.run(
            ["git", "show", f"{REF}:native/{name}"], cwd=REPO,
            capture_output=True, text=True)
        path = os.path.join(tmp, name)
        if src.returncode != 0:
            raise RuntimeError(f"git show failed for {name}: {src.stderr}")
        with open(path, "w") as f:
            f.write(src.stdout)
    out = os.path.join(tmp, "libold.so")
    subprocess.run(
        ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
         "-o", out] + [os.path.join(tmp, s) for s in SRCS],
        check=True, cwd=tmp)
    return out


def timed(fn, iters):
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:1200, 0:1536]
    smooth = (900 + (yy * 7 + xx * 3) % 2800
              + rng.integers(0, 32, yy.shape)).astype(np.uint16)
    h, w = smooth.shape
    mp = smooth.size / 1e6

    from imagepipe_tpu.nikon import encode_34713, parse_linearization
    from imagepipe_tpu.olympus import encode_olympus
    from imagepipe_tpu.pentax import PentaxHuff, encode_pentax
    from imagepipe_tpu import lj92 as lj92mod

    with tempfile.TemporaryDirectory() as tmp:
        old = ctypes.CDLL(build_old(tmp))
        new = ctypes.CDLL(NEW_SO)

        out = np.empty((h, w), np.uint16)
        results = {}

        # --- olympus ---
        ob = encode_olympus(smooth)[7:]  # preamble stripped host-side
        obuf = ctypes.create_string_buffer(ob, len(ob))

        def run_oly(lib):
            rc = lib.olympus_decode(obuf, ctypes.c_int64(len(ob)), w, h,
                                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
            assert rc == 0, rc

        # --- pentax ---
        pb = encode_pentax(np.minimum(smooth, 4095))
        table = np.ascontiguousarray(PentaxHuff.default().table)
        pbuf = ctypes.create_string_buffer(pb, len(pb))

        def run_pen(lib):
            rc = lib.pentax_decode(pbuf, ctypes.c_int64(len(pb)), w, h,
                                   table.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
            assert rc == 0, rc

        # --- nikon ---
        npay, nmeta = encode_34713(smooth, bits=14)
        tree, vpred, curve, split, _white = parse_linearization(nmeta, 14)
        nbuf = ctypes.create_string_buffer(npay, len(npay))
        vpred = np.ascontiguousarray(vpred, np.int32).reshape(-1)
        curve = np.ascontiguousarray(curve, np.uint16)

        def run_nik(lib):
            rc = lib.nikon_decode(nbuf, ctypes.c_int64(len(npay)),
                                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                                  w, h, tree, split,
                                  vpred.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                                  curve.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
            assert rc == 0, rc

        # --- lj92 ---
        lj = lj92mod.encode(smooth, ncomp=1, precision=14)
        ljbuf = ctypes.create_string_buffer(lj, len(lj))
        ljout = np.empty((h, w), np.uint16)

        def run_lj(lib):
            ow = ctypes.c_int(); oh = ctypes.c_int()
            oc = ctypes.c_int(); op = ctypes.c_int()
            rc = lib.lj92_decode(ljbuf, ctypes.c_int64(len(lj)),
                                 ljout.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                                 ctypes.c_int64(ljout.size),
                                 ctypes.byref(ow), ctypes.byref(oh),
                                 ctypes.byref(oc), ctypes.byref(op))
            assert rc == 0, rc

        for name, fn in [("olympus", run_oly), ("pentax", run_pen),
                         ("nikon34713", run_nik), ("lj92", run_lj)]:
            # verify old/new agree bit-exactly
            fn(new); new_out = (ljout if name == "lj92" else out).copy()
            fn(old); old_out = (ljout if name == "lj92" else out).copy()
            assert np.array_equal(new_out, old_out), f"{name} mismatch!"
            reps = []
            for _ in range(3):  # interleaved
                t_old = timed(lambda: fn(old), 3)
                t_new = timed(lambda: fn(new), 3)
                reps.append((mp / t_old, mp / t_new))
            results[name] = reps

    for name, reps in results.items():
        olds = ", ".join(f"{o:.1f}" for o, _ in reps)
        news = ", ".join(f"{n:.1f}" for _, n in reps)
        speedup = max(n for _, n in reps) / max(o for o, _ in reps)
        print(f"{name:12s} old [{olds}] new [{news}] MP/s  -> {speedup:.2f}x")


if __name__ == "__main__":
    main()
