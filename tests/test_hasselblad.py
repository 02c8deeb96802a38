"""Hasselblad compressed 3FR codec (imagepipe_tpu/hasselblad.py).

The reference reaches Hasselblad backs through rawloader
(/root/reference/src/pipeline.rs:264). The canonical encoder pins the
recalled dcraw `hasselblad_load_raw` bit layout by round-trip; the
python<->native differential fuzz pins the two decoders to each other;
the container tests pin the TIFF compression-7 routing end-to-end."""

import numpy as np
import pytest

from imagepipe_tpu import native
from imagepipe_tpu.decode import codec_family, decode_file
from imagepipe_tpu.hasselblad import (_ENC_CODES, _Ph1BitsWriter,
                                      _decode_python, decode_hasselblad,
                                      encode_hasselblad,
                                      parse_jpeg_header)
from imagepipe_tpu.vendor import read_tiffep
from tiffgen import TiffBuilder


def _roundtrip(img, psv):
    blob = encode_hasselblad(img, psv=psv)
    got = decode_hasselblad(blob, img.shape[1], img.shape[0])
    np.testing.assert_array_equal(got, img)
    return blob


def test_roundtrip_smooth_both_psv():
    img = (np.linspace(0, 60000, 24 * 32).reshape(24, 32)
           .astype(np.uint16))
    for psv in (1, 11):
        _roundtrip(img, psv)


def test_roundtrip_random_and_extremes():
    rng = np.random.default_rng(7)
    img = rng.integers(0, 65536, (16, 20), dtype=np.uint16)
    img[0, :6] = (0, 65535, 0, 65535, 32768, 32767)
    img[-1, -4:] = (65535, 0, 65535, 0)
    for psv in (1, 11):
        _roundtrip(img, psv)


def test_roundtrip_psv11_row2_predictor():
    # A vertical gradient makes the row-2 half-difference correction
    # carry real information; a wrong row reference cannot round-trip
    # through an encoder sharing the same mistake, but it WOULD change
    # the stream size ordering vs psv 1 on this image (the correction
    # shrinks diffs). Pin both the round-trip and the compression win.
    col = (np.arange(40, dtype=np.uint16) * 1500)[:, None]
    img = np.ascontiguousarray(
        np.broadcast_to(col, (40, 24)).astype(np.uint16))
    img += (np.arange(24, dtype=np.uint16) * 7)[None, :]
    b11 = _roundtrip(img, 11)
    b1 = _roundtrip(img, 1)
    assert len(b11) < len(b1)


def test_extend_special_65535_is_minus_32768():
    # Hand-build a stream: one row, two columns. First diff is the
    # 16-bit field 65535 (top bit set, so no extend-subtract), which
    # the special rule maps to -32768: pixel = 0x8000 - 32768 = 0.
    bw = _Ph1BitsWriter()
    cl, code = _ENC_CODES[16]
    bw.put(cl, code)                     # length code for s=0: 16
    bw.put(*_ENC_CODES[0])               # length code for s=1: 0
    bw.put(16, 65535)                    # the special field (s=1 has none)
    scan = bw.flush()
    head = encode_hasselblad(np.zeros((1, 2), np.uint16), psv=1)
    huff, psv, sp = parse_jpeg_header(head)
    out = _decode_python(scan, 2, 1, huff, psv)
    assert out[0, 0] == 0
    # s=1: pred = unmasked cur[-? no — col 0 pair] = 0x8000 + 0... the
    # second sample of the FIRST pair also starts from 0x8000.
    assert out[0, 1] == 0x8000


def test_python_native_agree_on_valid_streams():
    if not (native.have_native()
            and hasattr(native._lib, "hasselblad_decode")):
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(11)
    for psv in (1, 11):
        img = rng.integers(0, 65536, (10, 14), dtype=np.uint16)
        blob = encode_hasselblad(img, psv=psv)
        huff, p, sp = parse_jpeg_header(blob)
        py = _decode_python(blob[sp:], 14, 10, huff, p)
        nat = decode_hasselblad(blob, 14, 10)
        np.testing.assert_array_equal(py, nat)
        np.testing.assert_array_equal(py, img)


def test_fuzz_decoders_never_crash_and_agree():
    if not (native.have_native()
            and hasattr(native._lib, "hasselblad_decode")):
        pytest.skip("native lib unavailable")
    from imagepipe_tpu.hasselblad import _decode_native

    rng = np.random.default_rng(13)
    head = encode_hasselblad(np.zeros((2, 4), np.uint16), psv=11)
    huff, psv, sp = parse_jpeg_header(head)
    for trial in range(300):
        n = int(rng.integers(0, 80))
        scan = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        if trial % 3 == 0:
            # Bias toward valid prefixes: a real stream with a
            # truncated/corrupted tail.
            img = rng.integers(0, 65536, (4, 6), dtype=np.uint16)
            blob = encode_hasselblad(img, psv=11)
            scan = blob[parse_jpeg_header(blob)[2]:][:n]
        w, h = 6, 4
        try:
            py = _decode_python(scan, w, h, huff, psv)
            py_err = None
        except ValueError as e:
            py, py_err = None, str(e)
        try:
            nat = _decode_native(scan, w, h, huff, psv)
            nat_err = None
        except ValueError as e:
            nat, nat_err = None, str(e)
        assert (py is None) == (nat is None), (
            f"trial {trial}: python={py_err} native={nat_err}")
        if py is not None:
            np.testing.assert_array_equal(py, nat)


def make_3fr(img, psv=1, make="Hasselblad", model="H4D-40",
             samples=None) -> bytes:
    h, w = img.shape
    payload = encode_hasselblad(img, psv=psv)
    b = TiffBuilder("<")
    strip = b.add_blob(payload)
    tags = [
        (256, 4, [w]), (257, 4, [h]), (258, 3, [16]),
        (259, 3, [7]), (262, 3, [32803]),
        (273, 4, [strip]), (278, 4, [h]), (279, 4, [len(payload)]),
        (33421, 3, [2, 2]), (33422, 1, [0, 1, 1, 2]),
    ]
    if samples is not None:
        tags.append((277, 3, [samples]))
    raw_ifd = b.add_ifd(tags, chain=False)
    b.add_ifd([
        (271, 2, make), (272, 2, model), (274, 3, [1]),
        (330, 4, [raw_ifd]),
    ])
    return b.bytes()


def test_container_end_to_end(tmp_path):
    rng = np.random.default_rng(21)
    img = rng.integers(0, 65536, (16, 24), dtype=np.uint16)
    path = str(tmp_path / "shot.3fr")
    with open(path, "wb") as f:
        f.write(make_3fr(img, psv=11))
    raw = read_tiffep(path)
    np.testing.assert_array_equal(raw.data, img)
    assert raw.cfa.name == "RGGB"
    assert raw.make == "Hasselblad"
    assert codec_family(path) == "3fr-compressed"
    # Through the full registry + develop too.
    src = decode_file(path)
    np.testing.assert_array_equal(src.raw.data, img)


def test_container_multishot_refused(tmp_path):
    img = np.zeros((8, 12), np.uint16)
    path = str(tmp_path / "ms.3fr")
    with open(path, "wb") as f:
        f.write(make_3fr(img, samples=4))
    with pytest.raises(ValueError, match="multi-shot"):
        read_tiffep(path)


def test_uncompressed_3fr_still_tiffep(tmp_path):
    from test_tiffep import make_tiffep
    from test_vendor import _sensor

    data = _sensor(8, 16, seed=90)
    path = str(tmp_path / "shot.3fr")
    with open(path, "wb") as f:
        f.write(make_tiffep(data, make="Hasselblad", model="CFV-50"))
    raw = read_tiffep(path)
    np.testing.assert_array_equal(raw.data, data)
    assert codec_family(path) == "tiffep-3fr"


def test_truncated_and_corrupt_fail_loud(tmp_path):
    img = np.arange(8 * 12, dtype=np.uint16).reshape(8, 12)
    blob = encode_hasselblad(img, psv=1)
    with pytest.raises(ValueError, match="3FR"):
        decode_hasselblad(blob[: len(blob) // 3], 12, 8)
    with pytest.raises(ValueError, match="not a JPEG"):
        decode_hasselblad(b"\x00" * 64, 12, 8)
    with pytest.raises(ValueError, match="width"):
        decode_hasselblad(blob, 11, 8)  # odd width
