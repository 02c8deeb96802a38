"""Sony ARW v1 (DSLR-A100) — arw1.py + native/arw1.cc.

Canonical-encoder round-trips pin the recalled dcraw sony_arw_load_raw
semantics (provenance notes at the top of arw1.py — the fixed code
table's Kraft sum telescopes to exactly 1.0); the native twin is held
bit-identical by differential fuzz."""

import numpy as np
import pytest

from imagepipe_tpu.arw1 import (_code_table, _decode_python, decode_arw1,
                                encode_arw1)
from imagepipe_tpu.decode import codec_family, decode_file
from tiffgen import TiffBuilder


def make_arw1(data, model="DSLR-A100", wb=(1900, 1024, 1024, 1500),
              black=128) -> bytes:
    h, w = data.shape
    payload = encode_arw1(data)
    b = TiffBuilder("<")
    strip = b.add_blob(payload)
    raw_ifd = b.add_ifd([
        (256, 4, [w]), (257, 4, [h]), (258, 3, [12]), (259, 3, [1]),
        (262, 3, [32803]),
        (273, 4, [strip]), (278, 4, [h]), (279, 4, [len(payload)]),
        (33421, 3, [2, 2]), (33422, 1, [0, 1, 1, 2]),
    ], chain=False)
    b.add_ifd([
        (271, 2, "SONY"), (272, 2, model), (274, 3, [1]),
        (330, 4, [raw_ifd]),
        (0x7313, 3, list(wb)), (0x7310, 3, [black] * 4),
    ])
    return b.bytes()


def _sensor12(h, w, seed=0):
    rng = np.random.default_rng(seed)
    return (800 + np.cumsum(rng.integers(-9, 10, (h, w)), 0)
            ).clip(0, 4095).astype(np.uint16)


def test_arw1_code_table_is_complete_prefix_code():
    table = _code_table()
    assert sum(2.0 ** -clen for clen, _, _ in table) == 1.0
    assert sorted(v for _, _, v in table) == sorted(
        list(range(16)) + [16, 17])
    codes = {(clen, code) for clen, code, _ in table}
    for clen, code in codes:
        for p in range(1, clen):
            assert (p, code >> (clen - p)) not in codes


def test_arw1_decodes_end_to_end(tmp_path):
    data = _sensor12(16, 24, seed=40)
    path = str(tmp_path / "shot.arw")
    with open(path, "wb") as f:
        f.write(make_arw1(data))
    assert codec_family(path) == "arw-v1"
    src = decode_file(path)
    raw = src.raw
    np.testing.assert_array_equal(raw.data, data)
    assert raw.model == "DSLR-A100"
    assert raw.whitelevels[0] == 4095   # 12-bit fallback (no 0x787F tag)
    assert raw.blacklevels[0] == 128
    from imagepipe_tpu import Pipeline

    out = Pipeline.new_from_source(src).output_8bit(None)
    assert out.data.shape == (16, 24, 3)


def test_arw1_roundtrip_stress():
    rng = np.random.default_rng(41)
    for trial in range(8):
        h, w = 2 * int(rng.integers(1, 10)), int(rng.integers(1, 24))
        kind = trial % 4
        if kind == 0:
            img = _sensor12(h, w, seed=trial)
        elif kind == 1:
            img = np.full((h, w), 2222, np.uint16)
        elif kind == 2:   # full 12-bit random (worst-case diffs)
            img = rng.integers(0, 4096, (h, w)).astype(np.uint16)
        else:             # column-extreme stripes (stresses the
                          # right-to-left, parity-striped traversal)
            img = np.where((np.arange(w)[None, :]
                            ^ np.arange(h)[:, None]) & 1,
                           4095, 0).astype(np.uint16)
        st = encode_arw1(img)
        np.testing.assert_array_equal(decode_arw1(st, w, h), img,
                                      err_msg=f"trial {trial}")


def test_arw1_traversal_is_column_major_right_to_left():
    # A one-diff-per-sample probe: the FIRST decoded sample must be the
    # top-right pixel, the second the one two rows below it.
    img = np.zeros((4, 3), np.uint16)
    img[0, 2] = 5
    st = encode_arw1(img)
    # 5 encodes as (len 3 code, then 3 bits), first in the stream; a
    # decode of a 1-pixel-wide 2-row image from the same head bits
    # yields [5, then 5-5=0 ...] only if the traversal starts top-right.
    out = _decode_python(st, 3, 4)
    np.testing.assert_array_equal(out, img)


def test_arw1_truncated_and_out_of_range_fail_loud():
    img = _sensor12(6, 10, seed=42)
    st = encode_arw1(img)
    with pytest.raises(ValueError):
        _decode_python(st[: len(st) // 2], 10, 6)
    with pytest.raises(ValueError):
        _decode_python(st, 10, 5)   # odd height refuses
    with pytest.raises(ValueError):
        _decode_python(st, 12, 6)   # wrong geometry must not pass silently


def test_arw1_python_native_fuzz():
    from imagepipe_tpu import native
    from imagepipe_tpu.arw1 import _decode_native

    if not (native.have_native() and hasattr(native._lib, "arw1_decode")):
        pytest.skip("native library not built")
    rng = np.random.default_rng(43)
    img = _sensor12(6, 40, seed=43)
    st = encode_arw1(img)
    np.testing.assert_array_equal(_decode_native(st, 40, 6), img)
    np.testing.assert_array_equal(_decode_python(st, 40, 6), img)
    for trial in range(80):
        b = bytearray(st)
        for _ in range(int(rng.integers(1, 4))):
            b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        try:
            py = _decode_python(bytes(b), 40, 6)
        except ValueError:
            py = None
        try:
            nat = _decode_native(bytes(b), 40, 6)
        except ValueError:
            nat = None
        assert (py is None) == (nat is None), f"trial {trial}"
        if py is not None:
            np.testing.assert_array_equal(py, nat)


def test_arw1_full_size_strip_still_reads_uncompressed(tmp_path):
    # An A100-labeled file whose strip is the FULL uncompressed extent
    # must take the plain-strip path (the ARW1 route is gated on the
    # undersized strip), not misparse as a bitstream.
    from test_vendor import make_arw

    data = _sensor12(8, 12, seed=44)
    path = str(tmp_path / "u.arw")
    with open(path, "wb") as f:
        f.write(make_arw(data, model="DSLR-A100", bits=16))
    raw = decode_file(path).raw
    np.testing.assert_array_equal(raw.data, data)
