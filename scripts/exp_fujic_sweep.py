"""Randomized-geometry differential sweep of the fuji codec.

Broader than the unit tests: many (shape, stripe, bits, type) combos,
rough + smooth + extreme content, python-vs-native equality and
round-trip exactness. Run: JAX_PLATFORMS=cpu
python scripts/exp_fujic_sweep.py [trials]
"""

import sys

import numpy as np

sys.path.insert(0, ".")

from imagepipe_tpu.fujic import _decode_python, decode_fuji, encode_fuji


def main(trials=40):
    rng = np.random.default_rng(2024)
    fails = 0
    for t in range(trials):
        xt = bool(rng.integers(0, 2))
        unit = 3 if xt else 2
        w = unit * int(rng.integers(5, 40))
        h = int(rng.integers(2, 40))
        bits = int(rng.choice([12, 14, 16]))
        # stripe width: full, half-ish, or small
        choices = [w]
        for frac in (2, 3):
            bs = max(15 if xt else 18, (w // frac))
            bs -= bs % unit
            if bs >= (15 if xt else 18):
                choices.append(bs)
        bs = int(rng.choice(choices))
        kind = int(rng.integers(0, 3))
        if kind == 0:
            img = rng.integers(0, 1 << bits, (h, w), dtype=np.uint16)
        elif kind == 1:
            yy, xx = np.mgrid[0:h, 0:w]
            img = ((yy * 37 + xx * 11) % (1 << bits)).astype(np.uint16)
        else:
            img = np.zeros((h, w), np.uint16)
            img[::2, ::3] = (1 << bits) - 1
        try:
            blob, snapped = encode_fuji(img, raw_type=16 if xt else 0,
                                        raw_bits=bits, block_size=bs)
            a, _ = _decode_python(blob)
            b, _ = decode_fuji(blob)
            assert (a == b).all(), "py != native"
            assert (a[:h] == snapped).all(), "decode != snapped"
            if not xt:
                assert (snapped == img).all(), "bayer snapped"
        except Exception as e:
            fails += 1
            print(f"FAIL t={t} xt={xt} {h}x{w} bs={bs} bits={bits} "
                  f"kind={kind}: {e}")
        if (t + 1) % 10 == 0:
            print(f"{t + 1}/{trials} done, {fails} failures")
    print("RESULT:", "OK" if fails == 0 else f"{fails} FAILURES")
    return fails


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 40
    sys.exit(1 if main(n) else 0)
