"""Pentax PEF compressed codec (imagepipe_tpu/pentax.py + native/pentax.cc).

Strategy mirrors the NEF-34713 and Olympus codec tests: the canonical
encoder pins every stream mechanism by round-trip (both predictors, all
categories, the default tree AND parsed maker-note tables in both header
styles), the native decoder is differential-fuzzed against the Python
one, and the container integration goes through read_pef/decode_file.
The reference reaches this codec through rawloader
(/root/reference/src/pipeline.rs:264)."""

import numpy as np
import pytest

from imagepipe_tpu import native
from imagepipe_tpu.decode import decode_file
from imagepipe_tpu.pentax import (PentaxHuff, _decode_native,
                                  _decode_python, decode_pentax,
                                  encode_pentax)
from test_vendor import _sensor, make_pef

_HAVE_NATIVE = native.have_native() and hasattr(native._lib,
                                                "pentax_decode")


def _roundtrip(img, huff=None):
    blob = encode_pentax(img, huff)
    out = decode_pentax(blob, img.shape[1], img.shape[0], huff)
    np.testing.assert_array_equal(out, img)
    return blob


def test_default_tree_shape():
    # The public pentax_tree: 13 categories, complete Kraft sum, and the
    # shortest codes on the small-difference categories.
    h = PentaxHuff.default()
    assert sorted(s for s, _, _ in h.triples) == list(range(13))
    assert sum(4096 >> length for _, length, _ in h.triples) == 4096
    lens = {s: length for s, length, _ in h.triples}
    assert lens[3] == 2 and lens[4] == 2          # most probable
    assert lens[11] == 10 and lens[12] == 10      # least probable


@pytest.mark.parametrize("shape,seed", [
    ((8, 16), 0), ((13, 31), 1), ((32, 32), 2), ((5, 7), 3),
])
def test_roundtrip_uniform_table_random(shape, seed):
    img = _sensor(*shape, seed=seed, bits=12)
    _roundtrip(img, PentaxHuff.uniform(15))


def test_roundtrip_default_tree_smooth():
    # The default tree tops out at category 12, so feed it data whose
    # differences stay in 12 bits: smooth gradients and flat fields
    # (the real content of table-less-body PEFs).
    yy, xx = np.mgrid[0:24, 0:40]
    smooth = ((yy * 13 + xx * 7) % 4000).astype(np.uint16)
    _roundtrip(smooth)
    _roundtrip(np.zeros((6, 10), np.uint16))
    _roundtrip(np.full((6, 10), 3000, np.uint16))
    checker = np.where((yy + xx) % 2 == 0, 1400, 120).astype(np.uint16)
    _roundtrip(checker)


def test_roundtrip_14bit():
    img = _sensor(12, 20, seed=7, bits=14)
    _roundtrip(img, PentaxHuff.uniform(15))


def test_vertical_and_horizontal_predictors():
    # Column 0/1 predict from two rows up per row parity; others from
    # two columns left. A column-ramp exercises both directions.
    img = (np.arange(8)[:, None] * 64 + np.arange(12)[None, :] * 8
           ).astype(np.uint16)
    _roundtrip(img, PentaxHuff.uniform(15))


def test_spec_roundtrip_and_validation():
    h = PentaxHuff.uniform(15)
    for endian in ("<", ">"):
        h2 = PentaxHuff.from_spec(h.to_spec(endian), endian)
        np.testing.assert_array_equal(h2.table, h.table)
    d = PentaxHuff.default()
    np.testing.assert_array_equal(
        PentaxHuff.from_spec(d.to_spec(">"), ">").table, d.table)
    with pytest.raises(ValueError, match="truncated|header"):
        PentaxHuff.from_spec(h.to_spec(">")[:10], ">")
    with pytest.raises(ValueError, match="cover"):
        # Drop a symbol's span by giving it an over-long length.
        bad = [(s, length, p) for s, length, p in h.triples]
        s0, l0, p0 = bad[0]
        bad[0] = (s0, l0 + 1, p0 << 1)
        PentaxHuff(bad)


def test_truncated_stream_raises():
    img = _sensor(12, 20, seed=9, bits=12)
    h = PentaxHuff.uniform(15)
    blob = encode_pentax(img, h)
    with pytest.raises(ValueError, match="exhausted"):
        decode_pentax(blob[: len(blob) // 2], 20, 12, h)
    with pytest.raises(ValueError, match="exhausted"):
        decode_pentax(b"", 20, 12, h)


@pytest.mark.skipif(not _HAVE_NATIVE, reason="native library not built")
def test_native_matches_python_differential():
    rng = np.random.default_rng(77)
    h = PentaxHuff.uniform(15)
    for _ in range(12):
        ht = int(rng.integers(2, 20))
        w = int(rng.integers(2, 40))
        img = rng.integers(0, 1 << 14, (ht, w), dtype=np.uint16)
        mask = rng.random((ht, w)) < 0.1
        img[mask] = rng.choice([0, (1 << 14) - 1], size=int(mask.sum()))
        blob = encode_pentax(img, h)
        a = _decode_python(blob, w, ht, h)
        b = _decode_native(blob, w, ht, h)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, img)


def test_fuzz_decoders_never_crash_and_agree():
    rng = np.random.default_rng(5)
    h = PentaxHuff.uniform(15)
    img = _sensor(10, 16, seed=40, bits=12)
    blob = bytearray(encode_pentax(img, h))
    for _ in range(40):
        b = bytearray(blob)
        for _ in range(int(rng.integers(1, 4))):
            b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        body = bytes(b)
        try:
            py = _decode_python(body, 16, 10, h)
        except ValueError:
            py = None
        if _HAVE_NATIVE:
            try:
                nat = _decode_native(body, 16, 10, h)
            except ValueError:
                nat = None
            assert (py is None) == (nat is None)
            if py is not None:
                np.testing.assert_array_equal(py, nat)


def _mn_entries(huff, endian, wb=(18000, 8192, 8192, 11000),
                black=(30, 28, 29, 31)):
    return [
        (0x0200, 3, list(black)),
        (0x0201, 3, list(wb)),
        (0x0220, 7, huff.to_spec(endian)),
    ]


@pytest.mark.parametrize("style,endian", [("AOC", ">"), ("PENTAX", "<")])
def test_pef_compressed_container_decodes(tmp_path, style, endian):
    data = _sensor(16, 24, seed=21, bits=12)
    huff = PentaxHuff.uniform(15)
    blob = encode_pentax(data, huff)
    path = str(tmp_path / f"comp_{style}.pef")
    with open(path, "wb") as f:
        f.write(make_pef(data, bits=12, compression=65535, payload=blob,
                         makernote=_mn_entries(huff, endian),
                         mn_style=style))
    src = decode_file(path)
    raw = src.raw
    np.testing.assert_array_equal(raw.data, data)
    assert raw.cfa.name == "RGGB"
    assert raw.whitelevels[0] == (1 << 12) - 1
    # WB normalized to green=1 from maker-note 0x0201 (R G G B)
    assert raw.wb_coeffs[0] == pytest.approx(18000 / 8192)
    assert raw.wb_coeffs[1] == 1.0
    assert raw.wb_coeffs[2] == pytest.approx(11000 / 8192)
    # Black point from maker-note 0x0200 (stored R G1 G2 B)
    assert raw.blacklevels == (30, 28, 31, 29)


def test_pef_compressed_default_tree_container(tmp_path):
    # No 0x0220 tag in the note -> the fixed default tree.
    yy, xx = np.mgrid[0:12, 0:20]
    data = ((yy * 9 + xx * 5) % 3500).astype(np.uint16)
    blob = encode_pentax(data)  # default tree
    path = str(tmp_path / "deftree.pef")
    with open(path, "wb") as f:
        f.write(make_pef(data, bits=12, compression=65535, payload=blob,
                         makernote=[(0x0201, 3, [16000, 8000, 8000, 9000])],
                         mn_style="AOC"))
    raw = decode_file(path).raw
    np.testing.assert_array_equal(raw.data, data)
    assert raw.wb_coeffs[0] == pytest.approx(2.0)


def test_pef_uncompressed_keeps_makernote_calibration(tmp_path):
    data = _sensor(8, 16, seed=50, bits=14)
    path = str(tmp_path / "plain.pef")
    with open(path, "wb") as f:
        f.write(make_pef(data, bits=14,
                         makernote=_mn_entries(PentaxHuff.uniform(15), ">")))
    raw = decode_file(path).raw
    np.testing.assert_array_equal(raw.data, data)
    assert raw.wb_coeffs[0] == pytest.approx(18000 / 8192)
    assert raw.blacklevels[0] == 30


def test_pef_unknown_compression_still_rejected(tmp_path):
    data = _sensor(8, 16, seed=36)
    path = str(tmp_path / "odd.pef")
    with open(path, "wb") as f:
        f.write(make_pef(data, compression=7))
    from imagepipe_tpu.vendor import read_pef

    with pytest.raises(ValueError, match="compression"):
        read_pef(path)


def test_pef_corrupt_spec_raises_not_crashes(tmp_path):
    data = _sensor(8, 16, seed=37, bits=12)
    blob = encode_pentax(data, PentaxHuff.uniform(15))
    spec = bytearray(PentaxHuff.uniform(15).to_spec(">"))
    spec[-1] = 200  # absurd code length
    path = str(tmp_path / "badspec.pef")
    with open(path, "wb") as f:
        f.write(make_pef(data, bits=12, compression=65535, payload=blob,
                         makernote=[(0x0220, 7, bytes(spec))],
                         mn_style="AOC"))
    from imagepipe_tpu.vendor import read_pef

    with pytest.raises(ValueError, match="length"):
        read_pef(path)
