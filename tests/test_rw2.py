"""Panasonic RW2 (imagepipe_tpu/rw2.py + native/rw2.cc).

Strategy mirrors the other vendor codecs: the test encoder pins every
stream mechanism by round-trip (establishment, repeat, rebased steps at
every shift, group resets, multi-section rotation), the native decoder
is differential-fuzzed against the Python one, and the container
integration goes through read_rw2/decode_file. The reference reaches
Panasonic bodies through rawloader (/root/reference/src/pipeline.rs:264)."""

import struct

import numpy as np
import pytest

from imagepipe_tpu import native
from imagepipe_tpu.decode import decode_file
from imagepipe_tpu.rw2 import (_decode_native, _decode_python, _derotate,
                               decode_panasonic, encode_panasonic, read_rw2)
from tiffgen import TiffBuilder
from test_vendor import _sensor

_HAVE_NATIVE = native.have_native() and hasattr(native._lib, "rw2_decode")


def _smooth(h, w, seed=0, lo=400, amp=8):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    return (lo + (yy * 9 + xx * 3) % 3000
            + rng.integers(0, amp, (h, w))).astype(np.uint16)


def _roundtrip(img):
    blob, snapped = encode_panasonic(img, snap=True)
    out = decode_panasonic(blob, img.shape[1], img.shape[0])
    np.testing.assert_array_equal(out, snapped)
    return blob, snapped


def test_roundtrip_smooth_exact():
    img = _smooth(20, 42)
    blob, snapped = _roundtrip(img)
    np.testing.assert_array_equal(snapped, img)  # no snapping needed


def test_roundtrip_flat_and_extremes():
    for v in (16, 1000, 4095):
        img = np.full((8, 28), v, np.uint16)
        blob, snapped = _roundtrip(img)
        np.testing.assert_array_equal(snapped, img)


def test_roundtrip_random_snapped():
    # Random 12-bit data is not exactly representable (steps quantize by
    # the shift); the snapped image must round-trip exactly and sit
    # within the sh=4 quantization radius of the input.
    rng = np.random.default_rng(1)
    img = rng.integers(150, 4096, (16, 56), dtype=np.uint16)
    blob, snapped = _roundtrip(img)
    assert np.abs(snapped.astype(int) - img.astype(int)).max() <= 8


def test_width_alignment_invariant():
    # Partial tail groups would break the 128-bit chunk alignment
    # dcraw's addressing assumes (real v4 raw widths are multiples of
    # 14); the encoder refuses rather than emitting a corrupt stream.
    with pytest.raises(ValueError, match="multiple of 14"):
        encode_panasonic(_smooth(6, 15))


def test_multi_section_rotation():
    # >16384 pixels crosses 0x4000-byte sections, exercising the
    # per-section 0x2008 rotation and the 128-bit group alignment.
    img = (500 + (np.add.outer(np.arange(28) * 5, np.arange(1400)) % 700)
           ).astype(np.uint16)
    blob, snapped = _roundtrip(img)
    assert len(blob) % 0x4000 == 0 and len(blob) >= 3 * 0x4000


def test_truncated_stream_raises():
    img = _smooth(20, 42)
    blob, _ = encode_panasonic(img, snap=True)
    with pytest.raises(ValueError, match="exhausted"):
        decode_panasonic(b"", 42, 20)
    # Cutting at a section boundary: the decoder needs more sections
    # than exist for this many pixels.
    big = _smooth(28, 1400)
    bblob, _ = encode_panasonic(big, snap=True)
    with pytest.raises(ValueError, match="exhausted"):
        decode_panasonic(bblob[:0x4000], 1400, 28)


@pytest.mark.skipif(not _HAVE_NATIVE, reason="native library not built")
def test_native_matches_python_differential():
    rng = np.random.default_rng(77)
    for trial in range(10):
        h = int(rng.integers(2, 24))
        w = 14 * int(rng.integers(1, 5))
        img = rng.integers(16, 4096, (h, w), dtype=np.uint16)
        blob, snapped = encode_panasonic(img, snap=True)
        logical = _derotate(blob)
        a = _decode_python(logical, w, h)
        b = _decode_native(logical, w, h)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, snapped)


def test_fuzz_decoders_never_crash_and_agree():
    rng = np.random.default_rng(5)
    img = _smooth(10, 28, seed=40)
    blob, _ = encode_panasonic(img, snap=True)
    for _ in range(40):
        b = bytearray(blob)
        for _ in range(int(rng.integers(1, 4))):
            b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        logical = _derotate(bytes(b))
        try:
            py = _decode_python(logical, 28, 10)
        except ValueError:
            py = None
        if _HAVE_NATIVE:
            try:
                nat = _decode_native(logical, 28, 10)
            except ValueError:
                nat = None
            assert (py is None) == (nat is None)
            if py is not None:
                np.testing.assert_array_equal(py, nat)


def make_rw2(data, payload=None, model="DMC-GH4", cfa_code=1, bits=12,
             borders=None, blacks=(128, 127, 129), wb=(470, 256, 380),
             rawformat=None, uncompressed=False) -> bytes:
    """An RW2 container: TIFF with vendor magic 0x55 and Panasonic's
    private IFD0 tags; the raw payload offset rides tag 0x0118."""
    h, w = data.shape
    b = TiffBuilder("<")
    if payload is None:
        if uncompressed:
            payload = data.astype("<u2").tobytes()
        else:
            payload = encode_panasonic(data)
    strip = b.add_blob(payload)
    if borders is None:
        borders = (0, 0, h, w)  # top, left, bottom, right
    entries = [
        (0x0002, 3, [w]), (0x0003, 3, [h]),
        (0x0004, 3, [borders[0]]), (0x0005, 3, [borders[1]]),
        (0x0006, 3, [borders[2]]), (0x0007, 3, [borders[3]]),
        (0x0009, 3, [cfa_code]), (0x000A, 3, [bits]),
        (0x001C, 3, [blacks[0]]), (0x001D, 3, [blacks[1]]),
        (0x001E, 3, [blacks[2]]),
        (0x0024, 3, [wb[0]]), (0x0025, 3, [wb[1]]), (0x0026, 3, [wb[2]]),
        (0x0117, 4, [len(payload)]), (0x0118, 4, [strip]),
        (271, 2, "Panasonic"), (272, 2, model), (274, 3, [1]),
    ]
    if rawformat is not None:
        entries.append((0x002D, 3, [rawformat]))
    b.add_ifd(entries)
    blob = bytearray(b.bytes())
    struct.pack_into("<H", blob, 2, 0x55)  # RW2 vendor magic
    return bytes(blob)


def test_rw2_container_compressed_decodes(tmp_path):
    # Big enough that the compressed stream (sections of 16 KB) stays
    # under width*height*2 bytes — the reader's storage discriminator.
    img = _smooth(64, 224, seed=3)
    path = str(tmp_path / "shot.rw2")
    with open(path, "wb") as f:
        f.write(make_rw2(img))
    src = decode_file(path)
    raw = src.raw
    np.testing.assert_array_equal(raw.data, img)
    assert raw.cfa.name == "RGGB"
    assert raw.whitelevels[0] == 4095
    # Stored black + 15 (the public RawSpeed/rawloader convention).
    assert raw.blacklevels == (143, 142, 144, 142)
    assert raw.wb_coeffs[0] == pytest.approx(470 / 256)
    assert raw.wb_coeffs[2] == pytest.approx(380 / 256)


def test_rw2_trailing_data_stays_compressed(tmp_path):
    # A compressed payload followed by appended data (sidecar/recovery
    # padding) must NOT flip the reader into the uncompressed branch,
    # even when the trailing bytes push the extent past w*h*2.
    img = _smooth(16, 28, seed=33)
    payload = encode_panasonic(img)
    path = str(tmp_path / "trail.rw2")
    blob = make_rw2(img, payload=payload) + b"\xAB" * (16 * 28 * 2)
    with open(path, "wb") as f:
        f.write(blob)
    raw = read_rw2(path)
    np.testing.assert_array_equal(raw.data, img)


def test_rw2_container_uncompressed_decodes(tmp_path):
    img = _sensor(12, 20, seed=9, bits=12)
    path = str(tmp_path / "plain.rw2")
    with open(path, "wb") as f:
        f.write(make_rw2(img, uncompressed=True))
    raw = read_rw2(path)
    np.testing.assert_array_equal(raw.data, img)


def test_rw2_cfa_codes(tmp_path):
    img = _smooth(64, 224, seed=4)
    for code, name in ((1, "RGGB"), (2, "GRBG"), (3, "GBRG"), (4, "BGGR")):
        path = str(tmp_path / f"cfa{code}.rw2")
        with open(path, "wb") as f:
            f.write(make_rw2(img, cfa_code=code))
        assert read_rw2(path).cfa.name == name
    path = str(tmp_path / "cfa9.rw2")
    with open(path, "wb") as f:
        f.write(make_rw2(img, cfa_code=9))
    with pytest.raises(ValueError, match="CFA pattern code"):
        read_rw2(path)


def test_rw2_borders_to_crops(tmp_path):
    img = _smooth(64, 224, seed=5)
    path = str(tmp_path / "crop.rw2")
    with open(path, "wb") as f:
        f.write(make_rw2(img, borders=(2, 4, 60, 220)))
    raw = read_rw2(path)
    # crops order [top, right, bottom, left]
    assert raw.crops == (2, 224 - 220, 64 - 60, 4)


def test_rw2_fallback_balance_tags(tmp_path):
    img = _smooth(64, 224, seed=6)
    h, w = img.shape
    b = TiffBuilder("<")
    strip = b.add_blob(encode_panasonic(img))
    b.add_ifd([
        (0x0002, 3, [w]), (0x0003, 3, [h]), (0x0009, 3, [1]),
        (0x000A, 3, [12]), (0x0011, 3, [520]), (0x0012, 3, [370]),
        (0x0118, 4, [strip]), (271, 2, "Panasonic"), (272, 2, "DMC-LX3"),
    ])
    blob = bytearray(b.bytes())
    struct.pack_into("<H", blob, 2, 0x55)
    path = str(tmp_path / "old.rw2")
    with open(path, "wb") as f:
        f.write(bytes(blob))
    raw = read_rw2(path)
    assert raw.wb_coeffs[0] == pytest.approx(520 / 256)
    assert raw.wb_coeffs[2] == pytest.approx(370 / 256)
    assert raw.blacklevels == (0, 0, 0, 0)  # no black tags -> none


def test_rw2_unknown_rawformat_named(tmp_path):
    img = _smooth(8, 28, seed=7)
    path = str(tmp_path / "v9.rw2")
    with open(path, "wb") as f:
        # A short garbage payload with a RawFormat newer than any codec.
        f.write(make_rw2(img, payload=b"\0" * 64, rawformat=9))
    with pytest.raises(ValueError, match="RawFormat 9"):
        read_rw2(path)


def test_rw2_v6_12bit_container_roundtrip(tmp_path):
    from imagepipe_tpu.rw2 import decode_panasonic_v6, encode_panasonic_v6

    img = (_smooth(8, 28, seed=7) % 3000 + 600).astype(np.uint16)
    payload, snapped = encode_panasonic_v6(img, snap=True, bits=12)
    np.testing.assert_array_equal(snapped, img)
    path = str(tmp_path / "v6_12.rw2")
    with open(path, "wb") as f:
        f.write(make_rw2(img, payload=payload, rawformat=6, bits=12))
    raw = read_rw2(path)
    np.testing.assert_array_equal(raw.data, img)
    assert raw.whitelevels[0] == 4095


def test_rw2_develops_end_to_end(tmp_path):
    from imagepipe_tpu.pipeline import Pipeline

    img = _smooth(64, 224, seed=8)
    path = str(tmp_path / "dev.rw2")
    with open(path, "wb") as f:
        f.write(make_rw2(img))
    out = Pipeline.new_from_file(path).output_8bit()
    assert out.data.shape == (64, 224, 3)
    assert out.data.std() > 0


# ---------------------------------------------------------------------------
# RawFormat 5/6/7 (the newer codecs; see rw2.py's provenance note)
# ---------------------------------------------------------------------------

from imagepipe_tpu.rw2 import (_v6_parse_pages, _v6_emit_pages,
                               _v6_reconstruct, _decode_native_wh,
                               decode_panasonic_v5, encode_panasonic_v5,
                               decode_panasonic_v6, encode_panasonic_v6,
                               decode_panasonic_v7, encode_panasonic_v7)

_HAVE_V567 = native.have_native() and hasattr(native._lib, "rw2_decode_v6")


def _smooth14(h, w, seed=0, lo=600, span=300, amp=4):
    # Bounded same-parity deltas (< +-512) and values > 512 keep every
    # pixel exactly representable by the v6 scaled-delta scheme.
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    return (lo + (yy * 9 + xx * 3) % span
            + rng.integers(0, amp, (h, w))).astype(np.uint16)


@pytest.mark.parametrize("bits", [12, 14])
def test_v5_roundtrip_exact(bits):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 1 << bits, (24, 66), dtype=np.uint16)
    blob = encode_panasonic_v5(img, bits=bits)
    assert len(blob) % 0x4000 == 0  # whole rotated sections
    out = decode_panasonic_v5(blob, 66, 24, bits)
    np.testing.assert_array_equal(out, img)


def test_v5_multi_section():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 1 << 14, (40, 700), dtype=np.uint16)
    blob = encode_panasonic_v5(img, bits=14)
    assert len(blob) >= 3 * 0x4000
    out = decode_panasonic_v5(blob, 700, 40, 14)
    np.testing.assert_array_equal(out, img)
    with pytest.raises(ValueError, match="exhausted"):
        decode_panasonic_v5(blob[:0x4000], 700, 40, 14)


@pytest.mark.parametrize("bits,w", [(12, 40), (14, 36)])
def test_v7_roundtrip_exact(bits, w):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 1 << bits, (10, w), dtype=np.uint16)
    blob = encode_panasonic_v7(img, bits=bits)
    ppp = 128 // bits
    assert len(blob) == w // ppp * 16 * 10
    out = decode_panasonic_v7(blob, w, 10, bits)
    np.testing.assert_array_equal(out, img)


def test_v7_width_alignment():
    with pytest.raises(ValueError, match="multiple of 9"):
        encode_panasonic_v7(np.zeros((4, 10), np.uint16), bits=14)
    with pytest.raises(ValueError, match="multiple of 9"):
        decode_panasonic_v7(b"\0" * 160, 10, 4, 14)


def test_v6_roundtrip_smooth_exact():
    img = _smooth14(12, 44)
    blob, snapped = encode_panasonic_v6(img, snap=True)
    np.testing.assert_array_equal(snapped, img)  # no snapping needed
    out = decode_panasonic_v6(blob, 44, 12)
    np.testing.assert_array_equal(out, img)


def test_v6_roundtrip_flat_and_extremes():
    for v in (0, 15, 513, 16368):
        img = np.full((6, 33), v, np.uint16)
        blob, snapped = encode_panasonic_v6(img, snap=True)
        out = decode_panasonic_v6(blob, 33, 6)
        np.testing.assert_array_equal(out, snapped)
        np.testing.assert_array_equal(snapped, img)


def test_v6_roundtrip_random_snapped():
    # Arbitrary 14-bit data is not exactly representable (deltas
    # quantize by the selector scale); the snapped image must
    # round-trip exactly and stay within the absolute-coarse radius.
    rng = np.random.default_rng(5)
    img = rng.integers(600, 16368, (10, 55), dtype=np.uint16)
    blob, snapped = encode_panasonic_v6(img, snap=True)
    out = decode_panasonic_v6(blob, 55, 10)
    np.testing.assert_array_equal(out, snapped)
    assert np.abs(snapped.astype(int) - img.astype(int)).max() <= 24


def test_v6_unencodable_raises_without_snap():
    img = np.zeros((2, 11), np.uint16)
    img[0, 2] = 9000  # jump of +9000 from 0+bias: not exactly reachable
    with pytest.raises(ValueError, match="snap=True"):
        encode_panasonic_v6(img, snap=False)


def test_v6_width_alignment():
    with pytest.raises(ValueError, match="multiple of 11"):
        encode_panasonic_v6(np.zeros((2, 12), np.uint16), snap=True)


@pytest.mark.parametrize("bits", [14, 12])
def test_v6_page_field_roundtrip(bits):
    # The page bit layout is its own mechanism: emit<->parse must be
    # exact for every field pattern including all-ones boundaries.
    from imagepipe_tpu.rw2 import _V6_LAYOUTS

    lay = _V6_LAYOUTS[bits]
    rng = np.random.default_rng(6)
    widths = np.array(lay.fields)
    fields = np.empty((64, len(widths)), np.int32)
    for k, nb in enumerate(widths):
        fields[:, k] = rng.integers(0, 1 << nb, 64)
    fields[0] = (1 << widths) - 1
    fields[1] = 0
    blob = _v6_emit_pages(fields, lay)
    back = _v6_parse_pages(np.frombuffer(blob, np.uint8).reshape(-1, 16),
                           lay)
    np.testing.assert_array_equal(back, fields)


@pytest.mark.skipif(not _HAVE_V567, reason="native library not built")
def test_v567_native_matches_python_differential():
    rng = np.random.default_rng(8)
    lib = native._lib
    from imagepipe_tpu.rw2 import _V6_LAYOUTS

    for trial in range(8):
        h = int(rng.integers(2, 12))
        for bits in (14, 12):
            lay = _V6_LAYOUTS[bits]
            # v6 on encoded content
            w6 = lay.ppb * int(rng.integers(1, 6))
            img = rng.integers(0, (1 << bits) - 16, (h, w6),
                               dtype=np.uint16)
            blob, snapped = encode_panasonic_v6(img, snap=True, bits=bits)
            pages = np.frombuffer(blob, np.uint8).reshape(-1, 16)
            py = np.zeros((h, w6), np.uint16)
            py[:, :] = _v6_reconstruct(
                _v6_parse_pages(pages, lay), lay).reshape(h, w6)
            nat = _decode_native_wh(lib.rw2_decode_v6, blob, w6, h, bits)
            np.testing.assert_array_equal(py, nat)
            np.testing.assert_array_equal(py, snapped)
            # v6 on arbitrary bytes (every byte pattern is a valid stream)
            raw = rng.integers(0, 256, h * (w6 // lay.ppb) * 16,
                               dtype=np.uint8)
            rpages = raw.reshape(-1, 16)
            py = _v6_reconstruct(_v6_parse_pages(rpages, lay),
                                 lay).reshape(h, w6)
            nat = _decode_native_wh(lib.rw2_decode_v6, raw.tobytes(),
                                    w6, h, bits)
            np.testing.assert_array_equal(py, nat)
        # v5/v7 on arbitrary bytes
        for bits in (12, 14):
            ppp = 128 // bits
            wv = ppp * int(rng.integers(1, 8))
            n = h * (wv // ppp) * 16
            raw = rng.integers(0, 256, max(n, 0x4000), dtype=np.uint8).tobytes()
            pk = np.frombuffer(raw, np.uint8,
                               count=-(-h * wv // ppp) * 16).reshape(-1, 16)
            from imagepipe_tpu.rw2 import _unpack_lsb_packets
            py = _unpack_lsb_packets(pk, bits).ravel()[:h * wv].reshape(h, wv)
            nat = _decode_native_wh(lib.rw2_decode_v5, raw, wv, h, bits)
            np.testing.assert_array_equal(py, nat)
            py7 = _unpack_lsb_packets(
                np.frombuffer(raw, np.uint8, count=n).reshape(-1, 16),
                bits).reshape(h, wv)
            nat7 = _decode_native_wh(lib.rw2_decode_v7, raw[:n], wv, h, bits)
            np.testing.assert_array_equal(py7, nat7)


@pytest.mark.parametrize("rawformat", [5, 6, 7])
def test_rw2_container_newer_codecs(tmp_path, rawformat):
    h, w = 24, 11 * 9 * 2  # 198: multiple of 11 and 9 (and not of 14)
    img = _smooth14(h, w, seed=rawformat)
    if rawformat == 5:
        payload = encode_panasonic_v5(img, bits=14)
    elif rawformat == 6:
        payload, snapped = encode_panasonic_v6(img, snap=True)
        np.testing.assert_array_equal(snapped, img)
    else:
        payload = encode_panasonic_v7(img, bits=14)
    path = str(tmp_path / f"v{rawformat}.rw2")
    with open(path, "wb") as f:
        f.write(make_rw2(img, payload=payload, bits=14,
                         rawformat=rawformat))
    raw = read_rw2(path)
    np.testing.assert_array_equal(raw.data, img)
    assert raw.whitelevels[0] == 16383
    assert raw.blacklevels == (143, 142, 144, 142)


def test_rw2_v6_develops_end_to_end(tmp_path):
    from imagepipe_tpu.pipeline import Pipeline

    img = _smooth14(44, 110, seed=9)
    payload, _ = encode_panasonic_v6(img, snap=True)
    path = str(tmp_path / "v6dev.rw2")
    with open(path, "wb") as f:
        f.write(make_rw2(img, payload=payload, bits=14, rawformat=6))
    out = Pipeline.new_from_file(path).output_8bit()
    assert out.data.shape == (44, 110, 3)
    assert out.data.std() > 0


def test_rwl_leica_rebadge_decodes(tmp_path):
    # Leica RWL = the same magic-85 Panasonic container (rebadged
    # bodies); the .rwl extension must route to the RW2 reader, and
    # codec_family must classify the stream, not fall to TIFF-EP.
    from imagepipe_tpu.decode import codec_family

    img = _smooth(64, 224, seed=21)
    path = str(tmp_path / "shot.rwl")
    with open(path, "wb") as f:
        f.write(make_rw2(img, model="D-LUX 7"))
    assert codec_family(path) == "rw2-classic"
    raw = decode_file(path).raw
    np.testing.assert_array_equal(raw.data, img)
    assert raw.model == "D-LUX 7"
