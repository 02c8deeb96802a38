"""Kodak DCR/KDC compression-65000 — kodak.py + native/kodak.cc.

Canonical-encoder round-trips pin the recalled dcraw
kodak_65000_load_raw semantics (provenance notes at the top of
kodak.py); the native twin is held bit-identical by differential fuzz,
including identical fates on corrupted streams."""

import numpy as np
import pytest

from imagepipe_tpu.decode import codec_family, decode_file
from imagepipe_tpu.kodak import (_decode_python, decode_kodak65000,
                                 encode_kodak65000)
from tiffgen import TiffBuilder
from test_vendor import _sensor


def make_dcr(data, make="KODAK", model="DCS Pro 14N", ext_comp=65000,
             payload=None) -> bytes:
    h, w = data.shape
    if payload is None:
        payload = encode_kodak65000(data)
    b = TiffBuilder("<")
    strip = b.add_blob(payload)
    raw_ifd = b.add_ifd([
        (256, 4, [w]), (257, 4, [h]), (258, 3, [12]),
        (259, 3, [ext_comp]), (262, 3, [32803]),
        (273, 4, [strip]), (278, 4, [h]), (279, 4, [len(payload)]),
        (33421, 3, [2, 2]), (33422, 1, [0, 1, 1, 2]),
    ], chain=False)
    b.add_ifd([
        (271, 2, make), (272, 2, model), (274, 3, [1]),
        (330, 4, [raw_ifd]),
    ])
    return b.bytes()


def test_dcr_65000_decodes(tmp_path):
    data = (_sensor(12, 40, seed=30) % 4096).astype(np.uint16)
    path = str(tmp_path / "shot.dcr")
    with open(path, "wb") as f:
        f.write(make_dcr(data))
    assert codec_family(path) == "dcr-65000"
    src = decode_file(path)
    raw = src.raw
    np.testing.assert_array_equal(raw.data, data)
    assert raw.whitelevels[0] == 4095
    assert raw.cfa.name == "RGGB"
    from imagepipe_tpu import Pipeline

    out = Pipeline.new_from_source(src).output_8bit(None)
    assert out.data.shape == (12, 40, 3)


def test_kdc_65000_decodes(tmp_path):
    data = (_sensor(8, 24, seed=31) % 4096).astype(np.uint16)
    path = str(tmp_path / "shot.kdc")
    with open(path, "wb") as f:
        f.write(make_dcr(data, make="EASTMAN KODAK COMPANY",
                         model="KODAK P850 ZOOM"))
    assert codec_family(path) == "kdc-65000"
    np.testing.assert_array_equal(decode_file(path).raw.data, data)


def test_kodak_65000_roundtrip_stress():
    rng = np.random.default_rng(32)
    for trial in range(10):
        h = int(rng.integers(1, 8))
        # widths straddling the 256-pixel run boundary and the %8==4
        # pre-seed shapes (rounded counts 4, 12, 20 mod 32...)
        w = int(rng.integers(1, 600))
        kind = trial % 4
        if kind == 0:     # smooth sensor-like
            img = (900 + np.cumsum(rng.integers(-9, 10, (h, w)), 1)
                   ).clip(0, 4095).astype(np.uint16)
        elif kind == 1:   # constant
            img = np.full((h, w), 1234, np.uint16)
        elif kind == 2:   # full 12-bit random (worst-case lengths)
            img = rng.integers(0, 4096, (h, w)).astype(np.uint16)
        else:             # alternating extremes
            img = np.where((np.arange(w)[None, :]
                            + np.arange(h)[:, None]) & 1,
                           4095, 0).astype(np.uint16)
        st = encode_kodak65000(img)
        np.testing.assert_array_equal(decode_kodak65000(st, w, h), img,
                                      err_msg=f"trial {trial} {h}x{w}")


def test_kodak_65000_uncompressed_run_fallback():
    rng = np.random.default_rng(33)
    img = rng.integers(0, 4096, (3, 300)).astype(np.uint16)
    # The fallback is flagged by a nibble > 12 inside the scan span;
    # force pixel 0's high bits up so the first word carries one.
    img[1, 256] = 0xDFF
    st = encode_kodak65000(img, uncompressed_runs={(1, 256)})
    np.testing.assert_array_equal(_decode_python(st, 300, 3), img)
    # A fixture whose run data can't flag itself must fail loud.
    flat = np.zeros((1, 8), np.uint16)
    with pytest.raises(ValueError, match="flag"):
        encode_kodak65000(flat, uncompressed_runs={(0, 0)})


def test_kodak_65000_truncated_fails_loud():
    img = (_sensor(6, 32, seed=34) % 4096).astype(np.uint16)
    st = encode_kodak65000(img)
    for cut in (1, len(st) // 3, len(st) - 1):
        with pytest.raises(ValueError):
            _decode_python(st[:cut], 32, 6)
    with pytest.raises(ValueError):
        _decode_python(st, 40, 6)   # wrong geometry must not pass


def test_kodak_65001_refuses_by_name(tmp_path):
    data = (_sensor(4, 16, seed=35) % 4096).astype(np.uint16)
    path = str(tmp_path / "ycc.dcr")
    with open(path, "wb") as f:
        f.write(make_dcr(data, ext_comp=65001, payload=b"\0" * 64))
    assert codec_family(path) == "dcr-65001-unsupported"
    with pytest.raises(ValueError, match="65001"):
        decode_file(path)


def test_kodak_65000_python_native_fuzz():
    from imagepipe_tpu import native
    from imagepipe_tpu.kodak import _decode_native

    if not (native.have_native()
            and hasattr(native._lib, "kodak65000_decode")):
        pytest.skip("native library not built")
    rng = np.random.default_rng(36)
    img = (800 + np.cumsum(rng.integers(-9, 10, (5, 280)), 1)
           ).clip(0, 4095).astype(np.uint16)
    st = encode_kodak65000(img)
    np.testing.assert_array_equal(_decode_native(st, 280, 5), img)
    np.testing.assert_array_equal(_decode_python(st, 280, 5), img)
    # adversarial: corruptions must fail/succeed IDENTICALLY (corrupt
    # nibbles can flip runs into the uncompressed fallback — both
    # implementations must take it the same way) and never crash
    for trial in range(80):
        b = bytearray(st)
        for _ in range(int(rng.integers(1, 5))):
            b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        try:
            py = _decode_python(bytes(b), 280, 5)
        except ValueError:
            py = None
        try:
            nat = _decode_native(bytes(b), 280, 5)
        except ValueError:
            nat = None
        assert (py is None) == (nat is None), f"trial {trial}"
        if py is not None:
            np.testing.assert_array_equal(py, nat)
