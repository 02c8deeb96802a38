"""Minolta MRW container (imagepipe_tpu/mrw.py).

Synthesized \\0MRM block containers (PRD/WBG/RIF/TTW) with 12-bit
packed and 16-bit payloads; the reference reaches Minolta bodies
through rawloader (/root/reference/src/pipeline.rs:264)."""

import struct

import numpy as np
import pytest

from imagepipe_tpu.decode import decode_file
from imagepipe_tpu.mrw import read_mrw
from tiffgen import TiffBuilder, pack_12be
from test_vendor import _sensor


def make_mrw(data, depth=12, storage=0x52, cfa_code=0x01,
             wb=(2.0, 1.0, 1.0, 1.5), wb_denoms=(1, 1, 1, 1),
             model="DYNAX 7D", orientation=1, payload=None,
             endian=">") -> bytes:
    """Assemble an MRW: \\0MRM (or the little-endian \\0MRI variant) +
    PRD/WBG/TTW blocks + sensor payload. `wb` is (R, G1, G2, B) gains;
    stored value = gain * 2^(6+denom)."""
    from tiffgen import pack_12le

    h, w = data.shape
    en = endian
    prd = (b"21810002"
           + struct.pack(en + "HHHH", h, w, h, w)
           + bytes([depth, 12, storage, 0x00, 0x00, 0x00, cfa_code, 0x00]))
    wbg = (bytes(wb_denoms)
           + b"".join(struct.pack(en + "H", int(round(g * (1 << (6 + d)))))
                      for g, d in zip(wb, wb_denoms)))
    t = TiffBuilder(">")
    t.add_ifd([(271, 2, "KONICA MINOLTA"), (272, 2, model),
               (274, 3, [orientation])])
    ttw = t.bytes()

    blocks = (b"\0PRD" + struct.pack(en + "I", len(prd)) + prd
              + b"\0WBG" + struct.pack(en + "I", len(wbg)) + wbg
              + b"\0TTW" + struct.pack(en + "I", len(ttw)) + ttw)
    if payload is None:
        if storage == 0x52:
            payload = pack_12be(data) if en == ">" else pack_12le(data)
        else:
            payload = data.astype(f"{en}u2").tobytes()
    magic = b"\0MRM" if en == ">" else b"\0MRI"
    return magic + struct.pack(en + "I", len(blocks)) + blocks + payload


def test_mrw_12bit_packed_decodes(tmp_path):
    data = _sensor(24, 32, seed=60, bits=12)
    path = str(tmp_path / "shot.mrw")
    with open(path, "wb") as f:
        f.write(make_mrw(data))
    src = decode_file(path)
    raw = src.raw
    np.testing.assert_array_equal(raw.data, data)
    assert raw.cfa.name == "RGGB"
    assert raw.whitelevels[0] == 4095
    assert raw.wb_coeffs[0] == pytest.approx(2.0)
    assert raw.wb_coeffs[1] == 1.0
    assert raw.wb_coeffs[2] == pytest.approx(1.5)
    assert raw.make == "KONICA MINOLTA"
    assert raw.model == "DYNAX 7D"


def test_mrw_16bit_storage(tmp_path):
    data = _sensor(8, 16, seed=61, bits=12)
    path = str(tmp_path / "plain.mrw")
    with open(path, "wb") as f:
        f.write(make_mrw(data, depth=16, storage=0x59))
    raw = read_mrw(path)
    np.testing.assert_array_equal(raw.data, data)
    assert raw.whitelevels[0] == 65535


def test_mrw_wb_denominator_scaling(tmp_path):
    data = _sensor(8, 16, seed=62, bits=12)
    path = str(tmp_path / "wb.mrw")
    with open(path, "wb") as f:
        # Mixed per-channel denominators must cancel in the gains.
        f.write(make_mrw(data, wb=(1.75, 1.0, 1.0, 1.25),
                         wb_denoms=(2, 1, 1, 3)))
    raw = read_mrw(path)
    assert raw.wb_coeffs[0] == pytest.approx(1.75, abs=2e-2)
    assert raw.wb_coeffs[2] == pytest.approx(1.25, abs=2e-2)


def test_mrw_little_endian_variant(tmp_path):
    # The magic's 4th byte is a byte-order mark ('I' = LE, e.g. the
    # DiMAGE A200); integers AND payload words follow it.
    for storage in (0x52, 0x59):
        data = _sensor(8, 16, seed=67 + storage, bits=12)
        path = str(tmp_path / f"le{storage}.mrw")
        with open(path, "wb") as f:
            f.write(make_mrw(data, storage=storage, endian="<",
                             model="DiMAGE A200"))
        raw = read_mrw(path)
        np.testing.assert_array_equal(raw.data, data)
        assert raw.wb_coeffs[0] == pytest.approx(2.0)


def test_mrw_orientation(tmp_path):
    from imagepipe_tpu.raw import Orientation

    data = _sensor(8, 16, seed=63, bits=12)
    path = str(tmp_path / "rot.mrw")
    with open(path, "wb") as f:
        f.write(make_mrw(data, orientation=6))
    assert read_mrw(path).orientation == Orientation.Rotate90


def test_mrw_rejections(tmp_path):
    data = _sensor(8, 16, seed=64, bits=12)

    p1 = tmp_path / "bad_magic.mrw"
    p1.write_bytes(b"\0MRX" + b"\0" * 64)
    with pytest.raises(ValueError, match="MRM magic"):
        read_mrw(str(p1))

    p2 = tmp_path / "bad_cfa.mrw"
    p2.write_bytes(make_mrw(data, cfa_code=0x07))
    with pytest.raises(ValueError, match="bayer pattern"):
        read_mrw(str(p2))

    p3 = tmp_path / "bad_storage.mrw"
    p3.write_bytes(make_mrw(data, storage=0x40))
    with pytest.raises(ValueError, match="storage method"):
        read_mrw(str(p3))

    blob = make_mrw(data)
    p4 = tmp_path / "trunc.mrw"
    p4.write_bytes(blob[: len(blob) - 20])
    with pytest.raises(ValueError, match="truncated"):
        read_mrw(str(p4))


def test_mrw_byte_fuzz_never_crashes(tmp_path):
    rng = np.random.default_rng(9)
    blob = bytearray(make_mrw(_sensor(8, 16, seed=65, bits=12)))
    for _ in range(40):
        b = bytearray(blob)
        for _ in range(int(rng.integers(1, 5))):
            b[int(rng.integers(4, len(b)))] = int(rng.integers(0, 256))
        path = tmp_path / "fuzz.mrw"
        path.write_bytes(bytes(b))
        try:
            read_mrw(str(path))
        except ValueError:
            pass


def test_mrw_develops_end_to_end(tmp_path):
    from imagepipe_tpu.pipeline import Pipeline

    data = _sensor(32, 48, seed=66, bits=12)
    path = str(tmp_path / "dev.mrw")
    with open(path, "wb") as f:
        f.write(make_mrw(data))
    out = Pipeline.new_from_file(path).output_8bit()
    assert out.data.shape == (32, 48, 3)
    assert out.data.std() > 0
