"""Olympus ORF compressed codec (imagepipe_tpu/olympus.py + native/olympus.cc).

Strategy mirrors the NEF-34713 codec tests (test_vendor.py): the canonical
encoder pins every stream mechanism by round-trip (including the unary
escape), the native decoder is differential-fuzzed against the Python one,
and the container integration goes through read_orf/decode_file. The
reference reaches this codec through rawloader
(/root/reference/src/pipeline.rs:264)."""

import numpy as np
import pytest

from imagepipe_tpu import native
from imagepipe_tpu.decode import decode_file
from imagepipe_tpu.olympus import (_decode_native, _decode_python,
                                   decode_olympus, encode_olympus)
from test_vendor import _sensor, make_orf

_HAVE_NATIVE = native.have_native() and hasattr(native._lib,
                                                "olympus_decode")


def _roundtrip(img):
    blob = encode_olympus(img)
    out = decode_olympus(blob, img.shape[1], img.shape[0])
    np.testing.assert_array_equal(out, img)
    return blob


@pytest.mark.parametrize("shape,seed,bits", [
    ((8, 16), 0, 12), ((13, 31), 1, 12), ((32, 32), 2, 12),
    ((5, 7), 3, 10), ((16, 48), 4, 12),
])
def test_roundtrip_random(shape, seed, bits):
    img = _sensor(*shape, seed=seed, bits=bits)
    _roundtrip(img)


def test_roundtrip_structured():
    # Smooth gradients exercise the small-run carry widening (c[2]);
    # the checker pattern exercises the per-column-parity carry split.
    yy, xx = np.mgrid[0:24, 0:40]
    smooth = ((yy * 13 + xx * 7) % 4096).astype(np.uint16)
    _roundtrip(smooth)
    checker = np.where((yy + xx) % 2 == 0, 4000, 15).astype(np.uint16)
    _roundtrip(checker)
    _roundtrip(np.zeros((6, 10), np.uint16))
    _roundtrip(np.full((6, 10), 4095, np.uint16))


def test_roundtrip_escape_path():
    # Alternating extremes force residual classes >= 12 (the 12-zeros
    # escape with the explicit 16-nbits field).
    img = np.zeros((8, 12), np.uint16)
    img[::2, ::2] = 4095
    img[1::2, 1::2] = 4001
    blob = _roundtrip(img)
    # The escape must actually occur: a canonical non-escape stream for
    # this image would be longer than 12 zeros allow, so check the stream
    # contains a 12-zero run (two zero bytes straddle one somewhere).
    assert b"\x00\x00" in blob[7:]


def test_truncated_stream_raises():
    img = _sensor(12, 20, seed=9, bits=12)
    blob = encode_olympus(img)
    with pytest.raises(ValueError, match="exhausted|preamble"):
        decode_olympus(blob[: len(blob) // 2], 20, 12)
    with pytest.raises(ValueError, match="preamble"):
        decode_olympus(b"\x00\x00", 20, 12)


@pytest.mark.skipif(not _HAVE_NATIVE, reason="native library not built")
def test_native_matches_python_differential():
    rng = np.random.default_rng(77)
    for _ in range(12):
        h = int(rng.integers(2, 20))
        w = int(rng.integers(2, 40))
        img = rng.integers(0, 4096, (h, w), dtype=np.uint16)
        # Sprinkle extremes so escapes and the plane-fit predictor fire.
        mask = rng.random((h, w)) < 0.1
        img[mask] = rng.choice([0, 4095], size=int(mask.sum()))
        body = encode_olympus(img)[7:]
        a = _decode_python(body, w, h)
        b = _decode_native(body, w, h)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, img)


@pytest.mark.skipif(not _HAVE_NATIVE, reason="native library not built")
def test_native_rejects_truncation():
    img = _sensor(10, 24, seed=11, bits=12)
    body = encode_olympus(img)[7:]
    for cut in (0, 1, len(body) // 3, len(body) - 1):
        with pytest.raises(ValueError):
            _decode_native(body[:cut], 24, 10)


def test_orf_compressed_container_decodes(tmp_path):
    from imagepipe_tpu.vendor import register_orf_pattern

    register_orf_pattern("E-M5COMP", "RGGB")
    # Realistic (smooth-ish) sensor content: the storage sniffing treats
    # >= 2 bytes/px as plain 16-bit words, and real compressed streams
    # sit well under that (cameras would store uncompressed otherwise);
    # pure noise can exceed it and is not a representative container.
    yy, xx = np.mgrid[0:16, 0:24]
    rng = np.random.default_rng(21)
    data = (800 + yy * 19 + xx * 7
            + rng.integers(0, 32, (16, 24))).astype(np.uint16)
    blob = encode_olympus(data)
    assert len(blob) < data.size * 2  # stays out of the 16-bit sniff
    path = str(tmp_path / "comp.orf")
    with open(path, "wb") as f:
        f.write(make_orf(data, model="E-M5COMP", payload=blob,
                         wb=(2.0, 1.0, 1.5, float("nan"))))
    src = decode_file(path)
    raw = src.raw
    np.testing.assert_array_equal(raw.data, data)
    assert raw.cfa.name == "RGGB"
    assert raw.whitelevels[0] == (1 << 12) - 1


def test_orf_plain_formats_still_detected(tmp_path):
    # The storage sniffing (16-bit words vs packed-12 vs compressed) must
    # keep routing uncompressed payloads to _read_strips.
    from imagepipe_tpu.vendor import register_orf_pattern

    register_orf_pattern("E-M5COMP", "RGGB")
    for bits in (12, 16):
        data = _sensor(8, 32, seed=30 + bits, bits=12)
        path = str(tmp_path / f"plain{bits}.orf")
        with open(path, "wb") as f:
            f.write(make_orf(data, model="E-M5COMP", bits=bits))
        raw = decode_file(path).raw
        np.testing.assert_array_equal(raw.data, data)


def test_fuzz_decoder_never_crashes():
    # Corrupt streams must raise ValueError or decode to garbage, never
    # crash or hang; both decoders stay in lockstep where both succeed.
    rng = np.random.default_rng(5)
    img = _sensor(10, 16, seed=40, bits=12)
    blob = bytearray(encode_olympus(img))
    for _ in range(40):
        b = bytearray(blob)
        for _ in range(int(rng.integers(1, 4))):
            b[int(rng.integers(7, len(b)))] = int(rng.integers(0, 256))
        body = bytes(b[7:])
        try:
            py = _decode_python(body, 16, 10)
        except ValueError:
            py = None
        if _HAVE_NATIVE:
            try:
                nat = _decode_native(body, 16, 10)
            except ValueError:
                nat = None
            if py is not None and nat is not None:
                np.testing.assert_array_equal(py, nat)
