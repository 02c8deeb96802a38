"""Vendor RAW readers (NEF/CR2/ARW) against synthesized byte-accurate
containers (tiffgen.py): payload equality, calibration tag mapping, camera
matrix lookup, end-to-end develop parity with the same data fed directly."""

import numpy as np
import pytest

from imagepipe_tpu import ImageSource, Pipeline
from imagepipe_tpu.cameras import xyz_to_cam_for
from imagepipe_tpu.decode import decode_file
from imagepipe_tpu.raw import CFA, Orientation, RawImage

from tiffgen import TiffBuilder, pack_12le, pack_14be


def _sensor(h, w, seed=0, bits=14):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << bits, (h, w), dtype=np.uint16)


def _expected_raw(data, wb, black, white, model, make, cfa="RGGB",
                  crops=(0, 0, 0, 0)):
    return RawImage(
        width=data.shape[1], height=data.shape[0], cpp=1, crops=crops,
        blacklevels=(black,) * 4, whitelevels=(white,) * 4,
        wb_coeffs=wb, xyz_to_cam=xyz_to_cam_for(make, model),
        orientation=Orientation.Normal, cfa=CFA(cfa), data=data,
        make=make, model=model)


def _assert_develops_identically(got: RawImage, want: RawImage):
    po = Pipeline.new_from_source(ImageSource.from_raw(got)).output_8bit(None)
    pw = Pipeline.new_from_source(ImageSource.from_raw(want)).output_8bit(None)
    np.testing.assert_array_equal(po.data, pw.data)


# ---------------------------------------------------------------------------
# NEF
# ---------------------------------------------------------------------------


def make_nef(data, model="NIKON D850", wb_r=2.0, wb_b=1.5, black=150) -> bytes:
    h, w = data.shape
    b = TiffBuilder(">")  # NEFs are big-endian containers
    strip = b.add_blob(pack_14be(data))

    raw_ifd = b.add_ifd([
        (256, 4, [w]), (257, 4, [h]), (258, 3, [14]), (259, 3, [1]),
        (262, 3, [32803]),
        (273, 4, [strip]), (278, 4, [h]), (279, 4, [len(pack_14be(data))]),
        (33421, 3, [2, 2]), (33422, 1, [0, 1, 1, 2]),
    ], chain=False)

    # Nikon maker note: "Nikon\0" + version + embedded little-endian TIFF.
    note = TiffBuilder("<")
    note.add_ifd([
        (0x000C, 5, [(int(wb_r * 10000), 10000), (int(wb_b * 10000), 10000),
                     (10000, 10000), (10000, 10000)]),   # R, B, G1, G2
        (0x003D, 3, [black] * 4),
    ])
    note_blob = b"Nikon\0" + b"\x02\x11\x00\x00" + note.bytes()

    exif_ifd = b.add_ifd([(37500, 7, note_blob)], chain=False)

    b.add_ifd([
        (271, 2, "NIKON CORPORATION"), (272, 2, model), (274, 3, [1]),
        (330, 4, [raw_ifd]), (34665, 4, [exif_ifd]),
    ])
    return b.bytes()


def test_nef_decode(tmp_path):
    data = _sensor(48, 64, seed=1)
    path = str(tmp_path / "shot.nef")
    with open(path, "wb") as f:
        f.write(make_nef(data))
    src = decode_file(path)
    raw = src.raw
    np.testing.assert_array_equal(raw.data, data)
    assert (raw.width, raw.height) == (64, 48)
    assert raw.cfa.name == "RGGB"
    assert raw.make == "NIKON CORPORATION" and raw.model == "NIKON D850"
    assert raw.wb_coeffs[:3] == (pytest.approx(2.0), pytest.approx(1.0),
                                 pytest.approx(1.5))
    assert raw.blacklevels == (150,) * 4
    assert raw.whitelevels[0] == (1 << 14) - 1
    np.testing.assert_allclose(raw.xyz_to_cam,
                               xyz_to_cam_for("NIKON CORPORATION", "NIKON D850"))
    want = _expected_raw(data, (2.0, 1.0, 1.5, float("nan")), 150,
                         (1 << 14) - 1, "NIKON D850", "NIKON CORPORATION")
    _assert_develops_identically(raw, want)


def test_nef_compressed_without_metadata_rejected(tmp_path):
    # 34713 decode itself lives in nikon.py (tests/test_nikon.py); a
    # compressed NEF lacking the 0x0096 linearization blob must still fail
    # with the compression named, not decode garbage.
    data = _sensor(8, 16, seed=2)
    b = TiffBuilder(">")
    strip = b.add_blob(pack_14be(data))
    raw_ifd = b.add_ifd([
        (256, 4, [16]), (257, 4, [8]), (258, 3, [14]), (259, 3, [34713]),
        (262, 3, [32803]), (273, 4, [strip]), (279, 4, [len(pack_14be(data))]),
    ], chain=False)
    b.add_ifd([(271, 2, "NIKON CORPORATION"), (272, 2, "NIKON D6"),
               (330, 4, [raw_ifd])])
    path = str(tmp_path / "c.nef")
    with open(path, "wb") as f:
        f.write(b.bytes())
    from imagepipe_tpu.vendor import read_nef

    with pytest.raises(ValueError, match="34713"):
        read_nef(path)
    # decode_file surfaces the reason instead of a bare unknown-format error.
    with pytest.raises(ValueError, match="34713"):
        decode_file(path)


# ---------------------------------------------------------------------------
# CR2
# ---------------------------------------------------------------------------


def make_cr2(data, model="Canon EOS 5D Mark III", wb=(2000, 1024, 1024, 1500),
             sensor_info=None, n_slices=1, w1=None) -> bytes:
    """Lossless-JPEG CR2 with vertical slices (tag 0xC640)."""
    from imagepipe_tpu.lj92 import encode as lj92_encode

    h, w = data.shape
    if w1 is None:
        w1 = w // (n_slices + 1)
    w2 = w - n_slices * w1
    parts = [data[:, j * w1:(j + 1) * w1].ravel() for j in range(n_slices)]
    parts.append(data[:, n_slices * w1:].ravel())
    flat = np.concatenate(parts).reshape(h, w)
    payload = lj92_encode(flat, ncomp=2, precision=14)

    b = TiffBuilder("<", header_extra=b"CR\x02\x00")
    strip = b.add_blob(payload)

    # Canon maker note: bare IFD with main-file-relative offsets.
    colordata = [0] * 1312
    colordata[63:67] = list(wb)
    note_entries = [(0x4001, 3, colordata)]
    if sensor_info is not None:
        note_entries.append((0x00E0, 3, sensor_info))
    note_ifd = b.add_ifd(note_entries, chain=False)
    exif_ifd = b.add_ifd([(37500, 7, ("ptr", 256, note_ifd))], chain=False)

    b.add_ifd([
        (271, 2, "Canon"), (272, 2, model), (274, 3, [1]),
        (34665, 4, [exif_ifd]),
    ])
    b.add_ifd([
        (259, 3, [6]), (273, 4, [strip]), (279, 4, [len(payload)]),
        (0xC640, 3, [n_slices, w1, w2]),
    ])
    return b.bytes()


def test_cr2_decode_sliced(tmp_path):
    data = _sensor(32, 96, seed=3)
    path = str(tmp_path / "shot.cr2")
    with open(path, "wb") as f:
        f.write(make_cr2(data, n_slices=2, w1=32))
    src = decode_file(path)
    raw = src.raw
    np.testing.assert_array_equal(raw.data, data)
    assert raw.cfa.name == "RGGB"
    assert raw.model == "Canon EOS 5D Mark III"
    assert raw.wb_coeffs[:3] == (pytest.approx(2000.0), pytest.approx(1024.0),
                                 pytest.approx(1500.0))
    np.testing.assert_allclose(
        raw.xyz_to_cam, xyz_to_cam_for("Canon", "Canon EOS 5D Mark III"))
    want = _expected_raw(data, (2000.0, 1024.0, 1500.0, float("nan")), 0,
                         (1 << 14) - 1, "Canon EOS 5D Mark III", "Canon")
    _assert_develops_identically(raw, want)


def test_cr2_dark_frame_keeps_sof_precision(tmp_path):
    """A 14-bit frame whose data never exceeds 4095 must still report a
    14-bit white level: the SOF3 precision is authoritative, not data.max()."""
    data = (_sensor(16, 32, seed=12) & 0xFFF).astype(np.uint16)
    assert int(data.max()) <= 4095
    path = str(tmp_path / "dark.cr2")
    with open(path, "wb") as f:
        f.write(make_cr2(data))
    raw = decode_file(path).raw
    assert raw.whitelevels[0] == (1 << 14) - 1


def test_cr2_exclusive_sensor_info_rejected(tmp_path):
    """SensorInfo with exclusive right/bottom (== width/height) must not
    produce a negative crop."""
    data = _sensor(40, 64, seed=13)
    si = [1, 64, 40, 0, 0, 8, 4, 64, 40]   # right == width, bottom == height
    path = str(tmp_path / "excl.cr2")
    with open(path, "wb") as f:
        f.write(make_cr2(data, sensor_info=si))
    raw = decode_file(path).raw
    assert raw.crops == (0, 0, 0, 0)
    assert all(c >= 0 for c in raw.crops)


def test_nef_truncated_packed_strip_raises(tmp_path):
    """A 14-bit NEF whose strip byte count is smaller than the packed extent
    must raise, not hand an undersized buffer to the native unpacker."""
    data = _sensor(16, 32, seed=14)
    blob = bytearray(make_nef(data))
    # Shrink the strip byte count tag (279) in the raw IFD: find the packed
    # payload length and patch any occurrence of it as a big-endian u32.
    import struct as _struct
    payload_len = len(pack_14be(data))
    needle = _struct.pack(">I", payload_len)
    pos = blob.find(needle)
    assert pos > 0
    blob[pos:pos + 4] = _struct.pack(">I", 16)
    p = str(tmp_path / "short.nef")
    with open(p, "wb") as f:
        f.write(bytes(blob))
    from imagepipe_tpu.vendor import read_nef

    with pytest.raises(ValueError, match="truncated|strip"):
        read_nef(p)


def test_cr2_sensor_info_crops_and_black(tmp_path):
    # Masked border: left 8 columns dark (black level ~160).
    rng = np.random.default_rng(4)
    data = _sensor(40, 64, seed=4)
    data[:, :8] = rng.integers(150, 170, (40, 8), dtype=np.uint16)
    # SensorInfo: [_, w, h, _, _, left, top, right, bottom]
    si = [1, 64, 40, 0, 0, 8, 4, 63, 39]
    path = str(tmp_path / "border.cr2")
    with open(path, "wb") as f:
        f.write(make_cr2(data, sensor_info=si))
    raw = decode_file(path).raw
    assert raw.crops == (4, 0, 0, 8)  # (top, right, bottom, left)
    assert 150 <= raw.blacklevels[0] <= 170


# ---------------------------------------------------------------------------
# ARW
# ---------------------------------------------------------------------------


def make_arw(data, model="ILCE-7RM3", bits=16, wb=(2100, 1024, 1024, 1600),
             black=512, white=16300) -> bytes:
    h, w = data.shape
    b = TiffBuilder("<")
    if bits == 16:
        payload = data.astype("<u2").tobytes()
    else:
        payload = pack_12le(data)
    strip = b.add_blob(payload)
    raw_ifd = b.add_ifd([
        (256, 4, [w]), (257, 4, [h]), (258, 3, [bits]), (259, 3, [1]),
        (262, 3, [32803]),
        (273, 4, [strip]), (278, 4, [h]), (279, 4, [len(payload)]),
        (33421, 3, [2, 2]), (33422, 1, [0, 1, 1, 2]),
    ], chain=False)
    b.add_ifd([
        (271, 2, "SONY"), (272, 2, model), (274, 3, [1]),
        (330, 4, [raw_ifd]),
        (0x7313, 3, list(wb)), (0x7310, 3, [black] * 4), (0x787F, 3, [white]),
    ])
    return b.bytes()


def make_arw_sr2private(data, model="DSC-R1", key=0x4D2F9C01,
                        tags=None) -> bytes:
    """An ARW/SR2-style container whose calibration rides the
    LFSR-encrypted SR2Private block: the inner IFD's value pointers are
    FILE-relative and land inside the block (the layout dcraw's
    negative-base trick implies)."""
    import struct as s

    from imagepipe_tpu.sony_srf import sony_crypt

    if tags is None:
        tags = [(0x7313, 3, [2100, 1024, 1024, 1600]),
                (0x7310, 3, [512] * 4), (0x787F, 3, [16300])]
    h, w = data.shape
    b = TiffBuilder("<")
    payload = data.astype("<u2").tobytes()
    strip = b.add_blob(payload)
    raw_ifd = b.add_ifd([
        (256, 4, [w]), (257, 4, [h]), (258, 3, [16]), (259, 3, [1]),
        (262, 3, [32803]),
        (273, 4, [strip]), (278, 4, [h]), (279, 4, [len(payload)]),
        (33421, 3, [2, 2]), (33422, 1, [0, 1, 1, 2]),
    ], chain=False)
    b.align(4)
    blockoff = b.tell()
    n = len(tags)
    ifdsz = 2 + n * 12 + 4
    body, extra = b"", b""
    for tag, typ, vals in tags:
        pv = s.pack("<%dH" % len(vals), *vals)
        if len(pv) <= 4:
            body += s.pack("<HHI", tag, typ, len(vals)) + pv.ljust(4, b"\0")
        else:
            body += s.pack("<HHII", tag, typ, len(vals),
                           blockoff + ifdsz + len(extra))
            extra += pv
    content = s.pack("<H", n) + body + s.pack("<I", 0) + extra
    content += b"\0" * (-len(content) % 4)
    b.add_blob(sony_crypt(content, key))
    b.add_ifd([
        (271, 2, "SONY"), (272, 2, model), (274, 3, [1]),
        (330, 4, [raw_ifd]),
        (0x7200, 4, [blockoff]), (0x7201, 4, [len(content)]),
        (0x7221, 4, [key]),
    ])
    return b.bytes()


def test_arw_sr2private_encrypted_calibration(tmp_path):
    data = _sensor(16, 32, seed=6, bits=12)
    path = str(tmp_path / "r1.sr2")
    with open(path, "wb") as f:
        f.write(make_arw_sr2private(data))
    raw = decode_file(path).raw
    np.testing.assert_array_equal(raw.data, data)
    assert raw.wb_coeffs[:3] == (pytest.approx(2100.0),
                                 pytest.approx(1024.0),
                                 pytest.approx(1600.0))
    assert raw.blacklevels == (512,) * 4
    assert raw.whitelevels[0] == 16300


def test_arw_sr2private_grbg_order(tmp_path):
    # Older bodies store WB as 0x7303 (G R B G2).
    data = _sensor(8, 32, seed=7, bits=12)
    path = str(tmp_path / "old.sr2")
    with open(path, "wb") as f:
        f.write(make_arw_sr2private(
            data, tags=[(0x7303, 3, [1024, 2100, 1600, 1024])]))
    raw = decode_file(path).raw
    assert raw.wb_coeffs[:3] == (pytest.approx(2100.0),
                                 pytest.approx(1024.0),
                                 pytest.approx(1600.0))


@pytest.mark.parametrize("bits", [16, 12])
def test_arw_decode(tmp_path, bits):
    data = _sensor(32, 48, seed=5, bits=min(bits, 12))
    path = str(tmp_path / f"shot{bits}.arw")
    with open(path, "wb") as f:
        f.write(make_arw(data, bits=bits))
    raw = decode_file(path).raw
    np.testing.assert_array_equal(raw.data, data)
    assert raw.model == "ILCE-7RM3"
    assert raw.wb_coeffs[:3] == (pytest.approx(2100.0), pytest.approx(1024.0),
                                 pytest.approx(1600.0))
    assert raw.blacklevels == (512,) * 4
    assert raw.whitelevels[0] == 16300
    np.testing.assert_allclose(raw.xyz_to_cam, xyz_to_cam_for("SONY", "ILCE-7RM3"))
    want = _expected_raw(data, (2100.0, 1024.0, 1600.0, float("nan")), 512,
                         16300, "ILCE-7RM3", "SONY")
    _assert_develops_identically(raw, want)


def _arw2_pack_block(vmax, vmin, imax, imin, deltas):
    """One 16-byte ARW2 block from raw fields (11-bit max/min, 4-bit
    positions, fourteen 7-bit deltas)."""
    acc = (vmax & 0x7FF) | ((vmin & 0x7FF) << 11) | ((imax & 0xF) << 22) \
        | ((imin & 0xF) << 26)
    bit = 30
    for d in deltas:
        acc |= (d & 0x7F) << bit
        bit += 7
    return acc.to_bytes(16, "little")


def _arw2_oracle_block(vmax, vmin, imax, imin, deltas):
    """Scalar dcraw sony_arw2_load_raw semantics for one block: 11-bit
    pre-curve pixel values."""
    sh = 0
    while sh < 4 and (0x80 << sh) <= vmax - vmin:
        sh += 1
    pix, di = [], 0
    for i in range(16):
        if i == imax:
            pix.append(vmax)
        elif i == imin:
            pix.append(vmin)
        else:
            pix.append(min(vmin + (deltas[di] << sh), 0x7FF))
            di += 1
    return pix


def make_arw2(blocks, h, w, model="ILCE-7M3", curve_bp=(2000, 4000, 8000, 12000),
              wb=(2100, 1024, 1024, 1600), black=128) -> bytes:
    payload = b"".join(_arw2_pack_block(*blk) for blk in blocks)
    assert len(payload) == h * w
    b = TiffBuilder("<")
    strip = b.add_blob(payload)
    raw_ifd = b.add_ifd([
        (256, 4, [w]), (257, 4, [h]), (258, 3, [8]), (259, 3, [32767]),
        (262, 3, [32803]),
        (273, 4, [strip]), (278, 4, [h]), (279, 4, [len(payload)]),
        (33421, 3, [2, 2]), (33422, 1, [0, 1, 1, 2]),
    ], chain=False)
    b.add_ifd([
        (271, 2, "SONY"), (272, 2, model), (274, 3, [1]),
        (330, 4, [raw_ifd]),
        (0x7313, 3, list(wb)), (0x7310, 3, [black] * 4),
        (0x7010, 3, list(curve_bp)),
    ])
    return b.bytes()


def test_arw2_decode_matches_scalar_oracle(tmp_path):
    rng = np.random.default_rng(21)
    h, w = 16, 64
    blocks = []
    for _ in range(h * w // 16):
        vmin = int(rng.integers(0, 0x400))
        vmax = int(rng.integers(vmin, 0x800))
        imax = int(rng.integers(0, 16))
        # Real encoders never emit imax == imin (dcraw would read one delta
        # past the block); keep the positions distinct.
        imin = int((imax + 1 + rng.integers(0, 15)) % 16)
        deltas = [int(d) for d in rng.integers(0, 128, 14)]
        blocks.append((vmax, vmin, imax, imin, deltas))
    path = str(tmp_path / "c2.arw")
    with open(path, "wb") as f:
        f.write(make_arw2(blocks, h, w))

    from imagepipe_tpu.vendor import _sony_curve, read_arw
    from imagepipe_tpu.tiff import TiffFile

    with open(path, "rb") as f:
        curve = _sony_curve(TiffFile(f.read()).find(0x7010))
    got = read_arw(path)

    want = np.zeros((h, w), np.uint16)
    bi = 0
    for row in range(h):
        for span in range(w // 32):
            for parity in range(2):
                pix = _arw2_oracle_block(*blocks[bi]); bi += 1
                for k in range(16):
                    want[row, span * 32 + 2 * k + parity] = curve[pix[k] << 1] >> 2
    np.testing.assert_array_equal(got.data, want)
    assert got.whitelevels[0] == int(curve[0xFFE] >> 2)
    assert got.blacklevels == (128,) * 4
    # Develop parity with the same decoded plane fed directly.
    direct = _expected_raw(want, (2100.0, 1024.0, 1600.0, float("nan")), 128,
                           got.whitelevels[0], "ILCE-7M3", "SONY")
    _assert_develops_identically(got, direct)


def test_arw2_missing_curve_rejected(tmp_path):
    rng = np.random.default_rng(22)
    blocks = [(100, 50, 0, 1, [int(d) for d in rng.integers(0, 128, 14)])
              for _ in range(2 * 32 // 16)]
    blob = make_arw2(blocks, 2, 32)
    # Strip tag 0x7010 by rebuilding without it.
    b = TiffBuilder("<")
    payload = b"".join(_arw2_pack_block(*blk) for blk in blocks)
    strip = b.add_blob(payload)
    raw_ifd = b.add_ifd([
        (256, 4, [32]), (257, 4, [2]), (258, 3, [8]), (259, 3, [32767]),
        (262, 3, [32803]), (273, 4, [strip]), (279, 4, [len(payload)]),
        (33421, 3, [2, 2]), (33422, 1, [0, 1, 1, 2]),
    ], chain=False)
    b.add_ifd([(271, 2, "SONY"), (272, 2, "ILCE-7M3"), (330, 4, [raw_ifd])])
    path = str(tmp_path / "nocurve.arw")
    with open(path, "wb") as f:
        f.write(b.bytes())
    from imagepipe_tpu.vendor import read_arw

    with pytest.raises(ValueError, match="0x7010|tone-curve"):
        read_arw(path)
    del blob


def test_unknown_camera_falls_back_to_srgb(tmp_path):
    data = _sensor(16, 32, seed=7)
    path = str(tmp_path / "new.arw")
    with open(path, "wb") as f:
        f.write(make_arw(data, model="ILCE-99 FUTURE"))
    raw = decode_file(path).raw
    np.testing.assert_allclose(raw.xyz_to_cam[:3], np.eye(3, dtype=np.float32))
    # Still develops.
    Pipeline.new_from_source(ImageSource.from_raw(raw)).output_8bit(None)


def test_arw2_byte_fuzz_never_crashes(tmp_path):
    """Corrupted/truncated ARW2 containers decode or raise ValueError --
    never hang or escape with another exception type."""
    rng = np.random.default_rng(31)
    blocks = []
    for _ in range(16 * 32 // 16):
        vmax = int(rng.integers(0, 0x800))
        imax = int(rng.integers(0, 16))
        blocks.append((vmax, int(rng.integers(0, vmax + 1)), imax,
                       int((imax + 1) % 16),
                       [int(d) for d in rng.integers(0, 128, 14)]))
    blob = bytearray(make_arw2(blocks, 16, 32))
    from imagepipe_tpu.vendor import read_arw

    for i in range(30):
        bad = bytearray(blob)
        for _ in range(int(rng.integers(1, 5))):
            bad[int(rng.integers(8, len(bad)))] = int(rng.integers(0, 256))
        if rng.random() < 0.4:
            bad = bad[:int(rng.integers(8, len(bad)))]
        p = str(tmp_path / f"fz{i}.arw")
        with open(p, "wb") as f:
            f.write(bytes(bad))
        try:
            read_arw(p)
        except ValueError:
            pass


def test_vendor_truncated_files_raise(tmp_path):
    """Truncated vendor containers fail with ValueError, never hang/crash."""
    data = _sensor(16, 32, seed=8)
    for name, blob in (("t.nef", make_nef(data)),
                       ("t.cr2", make_cr2(data)),
                       ("t.arw", make_arw(data))):
        for cut in (10, 60, len(blob) // 2):
            path = str(tmp_path / f"{cut}_{name}")
            with open(path, "wb") as f:
                f.write(blob[:cut])
            with pytest.raises(ValueError):
                decode_file(path)


# ---------------------------------------------------------------------------
# ORF (Olympus) / PEF (Pentax)
# ---------------------------------------------------------------------------


def olympus_new_note(ip_tags, subdir_inline=False) -> bytes:
    """A self-contained new-style Olympus maker note ('OLYMPUS\\0II' +
    version, IFD at note+12, NOTE-relative offsets) whose single entry
    is the ImageProcessing sub-IFD (0x2040) — stored as an IFD-typed
    pointer or inline UNDEFINED payload."""
    import struct as s

    def pack_vals(typ, vals):
        fmt = {3: "H", 4: "I", 8: "h"}[typ]
        return s.pack("<%d%s" % (len(vals), fmt), *vals)

    def build_ifd(tags, data_start):
        body, extra = b"", b""
        for tag, typ, vals in tags:
            pv = pack_vals(typ, vals)
            if len(pv) <= 4:
                body += s.pack("<HHI", tag, typ, len(vals)) + pv.ljust(4, b"\0")
            else:
                body += s.pack("<HHII", tag, typ, len(vals),
                               data_start + len(extra))
                extra += pv
        return s.pack("<H", len(tags)) + body + s.pack("<I", 0), extra

    head = b"OLYMPUS\0II\x03\x00"
    main_size = 2 + 1 * 12 + 4
    nested_off = 12 + main_size
    nested_size = 2 + len(ip_tags) * 12 + 4
    nested, extra = build_ifd(ip_tags, nested_off + nested_size)
    if subdir_inline:
        main = (s.pack("<H", 1)
                + s.pack("<HHII", 0x2040, 7, len(nested) + len(extra),
                         nested_off)
                + s.pack("<I", 0))
    else:
        main = (s.pack("<H", 1) + s.pack("<HHII", 0x2040, 13, 1, nested_off)
                + s.pack("<I", 0))
    return head + main + nested + extra


def make_orf(data, model="E-M1MarkII", wb=None, bits=12,
             with_cfa_tags=False, compression=1, payload=None,
             ip_tags=None, ip_inline=False) -> bytes:
    from tiffgen import pack_12le

    h, w = data.shape
    b = TiffBuilder("<")
    if payload is not None:
        pass  # caller supplies the strip bytes (e.g. olympus-compressed)
    elif bits == 12:
        payload = pack_12le(data)
    else:
        payload = data.astype("<u2").tobytes()
    strip = b.add_blob(payload)

    exif_ifd = None
    if ip_tags is not None:
        note = olympus_new_note(ip_tags, subdir_inline=ip_inline)
        noteoff = b.add_blob(note)
        exif_ifd = b.add_ifd([(37500, 7, ("ptr", len(note), noteoff))],
                             chain=False)
    elif wb is not None:
        # Old-style Olympus note: "OLYMP\0\0\0" + bare IFD, file-relative.
        prefix = b.add_blob(b"OLYMP\0\0\0")
        b.add_ifd([(0x1017, 3, [int(wb[0] * 256), 256]),
                   (0x1018, 3, [int(wb[2] * 256), 256])], chain=False)
        exif_ifd = b.add_ifd([(37500, 7, ("ptr", 64, prefix))], chain=False)

    entries = [
        (256, 4, [w]), (257, 4, [h]), (258, 3, [bits]),
        (259, 3, [compression]),
        (271, 2, "OLYMPUS CORPORATION"), (272, 2, model), (274, 3, [1]),
        (273, 4, [strip]), (278, 4, [h]), (279, 4, [len(payload)]),
    ]
    if with_cfa_tags:
        entries += [(262, 3, [32803]), (33421, 3, [2, 2]),
                    (33422, 1, [0, 1, 1, 2])]
    if exif_ifd is not None:
        entries.append((34665, 4, [exif_ifd]))
    b.add_ifd(entries)
    blob = bytearray(b.bytes())
    import struct as _s
    _s.pack_into("<H", blob, 2, 0x4F52)     # 'RO' vendor magic
    return bytes(blob)


def test_orf_decode_12bit_packed(tmp_path):
    from imagepipe_tpu.vendor import register_orf_pattern

    data = _sensor(24, 64, seed=31, bits=12)
    register_orf_pattern("E-M1MarkII", "RGGB")
    path = str(tmp_path / "shot.orf")
    with open(path, "wb") as f:
        f.write(make_orf(data, wb=(2.1, 1.0, 1.6, float("nan"))))
    src = decode_file(path)
    raw = src.raw
    np.testing.assert_array_equal(raw.data, data)
    assert raw.cfa.name == "RGGB"
    assert raw.whitelevels[0] == 4095
    assert raw.wb_coeffs[0] == pytest.approx(2.1, abs=1e-2)
    assert raw.wb_coeffs[2] == pytest.approx(1.6, abs=1e-2)


_IP_MATRIX_256 = [432, 65536 - 96, 65536 - 80,
                  65536 - 64, 400, 65536 - 80,
                  16, 65536 - 160, 400]  # rows sum to 256 (cam->sRGB x256)


@pytest.mark.parametrize("inline", [False, True])
def test_orf_imageprocessing_calibration(tmp_path, inline):
    """The new-style 'OLYMPUS\\0II' note's ImageProcessing sub-IFD feeds
    per-FILE calibration: WB levels, the camera->sRGB color matrix
    (signed /256), per-position black levels, valid bits, and crop."""
    from imagepipe_tpu.cameras import xyz_to_cam_from_cam2srgb
    from imagepipe_tpu.vendor import read_orf, register_orf_pattern

    register_orf_pattern("E-M1MarkII", "RGGB")
    data = _sensor(24, 64, seed=33, bits=12)
    ip_tags = [
        (0x0100, 3, [520, 370]),            # WB R/B x256
        (0x0200, 3, _IP_MATRIX_256),        # ColorMatrix
        (0x0600, 3, [255, 254, 253, 252]),  # BlackLevel2 (positions)
        (0x0611, 3, [12, 12]),              # ValidBits
        (0x0612, 3, [4]), (0x0613, 3, [2]),
        (0x0614, 3, [56]), (0x0615, 3, [20]),
    ]
    path = str(tmp_path / "ip.orf")
    with open(path, "wb") as f:
        f.write(make_orf(data, ip_tags=ip_tags, ip_inline=inline))
    raw = read_orf(path)
    np.testing.assert_array_equal(raw.data, data)
    assert raw.wb_coeffs[0] == pytest.approx(520 / 256)
    assert raw.wb_coeffs[2] == pytest.approx(370 / 256)
    m = np.array([432, -96, -80, -64, 400, -80, 16, -160, 400],
                 np.float32).reshape(3, 3) / 256.0
    np.testing.assert_allclose(raw.xyz_to_cam,
                               xyz_to_cam_from_cam2srgb(m), rtol=1e-5)
    assert raw.blacklevels == (255, 254, 252, 253)  # R G1 B G2
    assert raw.whitelevels[0] == 4095
    assert raw.crops == (2, 64 - 4 - 56, 24 - 2 - 20, 4)


def test_orf_imageprocessing_implausible_matrix_ignored(tmp_path):
    from imagepipe_tpu.vendor import read_orf, register_orf_pattern

    register_orf_pattern("E-M1MarkII", "RGGB")
    data = _sensor(8, 32, seed=34, bits=12)
    ip_tags = [(0x0200, 3, [9999] * 9)]  # rows don't sum near 1
    path = str(tmp_path / "bad.orf")
    with open(path, "wb") as f:
        f.write(make_orf(data, ip_tags=ip_tags))
    raw = read_orf(path)
    # Falls back to the registry path (sRGB identity warning for this
    # synthetic model) instead of trusting a nonsense matrix.
    assert raw.xyz_to_cam[0, 0] != 0


def test_orf_16bit_with_cfa_tags(tmp_path):
    data = _sensor(16, 32, seed=32, bits=16)
    path = str(tmp_path / "shot16.orf")
    with open(path, "wb") as f:
        f.write(make_orf(data, bits=16, with_cfa_tags=True))
    from imagepipe_tpu.vendor import read_orf

    raw = read_orf(path)
    np.testing.assert_array_equal(raw.data, data)
    assert raw.cfa.name == "RGGB"


def test_orf_12bit_data_in_16bit_words(tmp_path):
    """BitsPerSample=12 with 2-byte storage (the common Olympus layout):
    white level must be 4095, not 65535 (review finding)."""
    data = _sensor(16, 32, seed=38, bits=12)
    path = str(tmp_path / "w16b12.orf")
    blob = make_orf(data, bits=16, with_cfa_tags=True)
    # Rewrite BitsPerSample (258) to 12 while keeping 16-bit storage.
    import struct as _s
    b = bytearray(blob)
    i = b.find(_s.pack("<HH", 258, 3))
    assert i > 0
    _s.pack_into("<I", b, i + 8, 12)
    with open(path, "wb") as f:
        f.write(bytes(b))
    from imagepipe_tpu.vendor import read_orf

    raw = read_orf(path)
    np.testing.assert_array_equal(raw.data, data)
    assert raw.whitelevels[0] == 4095


def test_orf_unregistered_pattern_rejected(tmp_path):
    data = _sensor(8, 32, seed=33, bits=12)
    path = str(tmp_path / "mystery.orf")
    with open(path, "wb") as f:
        f.write(make_orf(data, model="E-UNKNOWN"))
    from imagepipe_tpu.vendor import read_orf

    with pytest.raises(ValueError, match="pattern"):
        read_orf(path)


def test_orf_compressed_rejected(tmp_path):
    data = _sensor(8, 32, seed=34, bits=12)
    path = str(tmp_path / "comp.orf")
    with open(path, "wb") as f:
        f.write(make_orf(data, compression=65535, with_cfa_tags=True))
    from imagepipe_tpu.vendor import read_orf

    with pytest.raises(ValueError, match="compressed"):
        read_orf(path)


def _pentax_style_note(entries) -> bytes:
    """Assemble a newer-style Pentax maker note: 'PENTAX \\0' + 'II',
    IFD at note offset 10, note-relative offsets, little-endian.
    entries: (tag, typ, values) with typ in {1/7: bytes, 3: u16 list}."""
    import struct as _s

    head = b"PENTAX \0II"
    n = len(entries)
    data_off = 10 + 2 + 12 * n + 4
    body = b""
    rows = b""
    for tag, typ, vals in sorted(entries):
        if typ in (1, 7):
            payload = bytes(vals)
            count = len(payload)
        elif typ == 3:
            payload = b"".join(_s.pack("<H", v) for v in vals)
            count = len(vals)
        else:
            raise AssertionError(f"unsupported note type {typ}")
        if len(payload) <= 4:
            val = payload + b"\0" * (4 - len(payload))
        else:
            val = _s.pack("<I", data_off + len(body))
            body += payload
        rows += _s.pack("<HHI", tag, typ, count) + val
    return (head + _s.pack("<H", n) + rows + _s.pack("<I", 0) + body)


def make_pef(data, model="PENTAX K-1", bits=14, compression=1,
             payload=None, makernote=None, mn_style="AOC") -> bytes:
    """`makernote`: optional list of (tag, typ, values) for a Pentax
    note — 'AOC' style (file-relative offsets, container order) or
    'PENTAX' style (note-relative offsets, own 'II' order)."""
    h, w = data.shape
    b = TiffBuilder(">")
    if payload is None:
        payload = pack_14be(data) if bits == 14 \
            else data.astype(">u2").tobytes()
    strip = b.add_blob(payload)
    exif_ifd = None
    if makernote is not None:
        if mn_style == "AOC":
            # 'AOC\0' + 2 pad bytes, bare IFD follows, offsets
            # file-relative in the container's (big-endian) order.
            prefix = b.add_blob(b"AOC\0\0\0")
            b.add_ifd(makernote, chain=False)
            exif_ifd = b.add_ifd([(37500, 7, ("ptr", 256, prefix))],
                                 chain=False)
        else:
            # 'PENTAX \0' + 'II' + an IFD at note offset 10 whose
            # offsets are note-relative, in its own (LE) byte order.
            note = _pentax_style_note(makernote)
            prefix = b.add_blob(note)
            exif_ifd = b.add_ifd([(37500, 7, ("ptr", len(note), prefix))],
                                 chain=False)
    raw_ifd = b.add_ifd([
        (256, 4, [w]), (257, 4, [h]), (258, 3, [bits]),
        (259, 3, [compression]), (262, 3, [32803]),
        (273, 4, [strip]), (278, 4, [h]), (279, 4, [len(payload)]),
        (33421, 3, [2, 2]), (33422, 1, [0, 1, 1, 2]),
    ], chain=False)
    root = [
        (271, 2, "PENTAX Corporation"), (272, 2, model), (274, 3, [1]),
        (330, 4, [raw_ifd]),
    ]
    if exif_ifd is not None:
        root.append((34665, 4, [exif_ifd]))
    b.add_ifd(root)
    return b.bytes()


def test_pef_decode(tmp_path):
    data = _sensor(24, 48, seed=35)
    path = str(tmp_path / "shot.pef")
    with open(path, "wb") as f:
        f.write(make_pef(data))
    src = decode_file(path)
    raw = src.raw
    np.testing.assert_array_equal(raw.data, data)
    assert raw.cfa.name == "RGGB"
    assert raw.whitelevels[0] == (1 << 14) - 1
    assert all(np.isnan(v) for v in raw.wb_coeffs[:3])  # neutral fallback


def test_cr2_sraw_rejected_by_name(tmp_path):
    # sRAW/mRAW carries a 3-component YCbCr lossless-JPEG frame; decoding
    # it as a mosaic would produce convincing garbage, so read_cr2 must
    # refuse with the flavor named (dcraw routes these to
    # canon_sraw_load_raw instead).
    from imagepipe_tpu.lj92 import encode as lj92_encode
    from imagepipe_tpu.vendor import read_cr2

    data = _sensor(8, 48, seed=91, bits=14)  # 16 px x 3 comps
    payload = lj92_encode(data, ncomp=3, precision=14)
    b = TiffBuilder("<", header_extra=b"CR\x02\x00")
    strip = b.add_blob(payload)
    b.add_ifd([(271, 2, "Canon"), (272, 2, "Canon EOS 5D Mark II"),
               (259, 3, [6]), (273, 4, [strip]), (279, 4, [len(payload)])])
    path = str(tmp_path / "sraw.cr2")
    with open(path, "wb") as f:
        f.write(b.bytes())
    with pytest.raises(ValueError, match="sRAW"):
        read_cr2(path)


def test_pef_garbage_compressed_stream_never_crashes(tmp_path):
    # Compression 65535 with a payload that is NOT a valid Huffman
    # stream must either raise ValueError (exhausted) or decode to
    # bounded garbage like dcraw — never crash (test_pentax.py covers
    # real streams, truncation, and byte fuzz).
    data = _sensor(8, 16, seed=36)
    path = str(tmp_path / "comp.pef")
    with open(path, "wb") as f:
        f.write(make_pef(data, compression=65535))
    from imagepipe_tpu.vendor import read_pef

    try:
        raw = read_pef(path)
        assert raw.data.shape == (8, 16)
    except ValueError:
        pass


def test_known_unsupported_formats_named(tmp_path):
    """CR3 containers fail with the codec gap named, not a PIL error
    (RW2 decodes natively now; its RawFormat>=5 gap test lives in
    test_rw2.py)."""
    cr3 = tmp_path / "shot.cr3"
    cr3.write_bytes(b"\x00\x00\x00\x18ftypcrx \x00\x00\x00\x01" + b"\0" * 64)
    with pytest.raises(ValueError, match="crx"):
        decode_file(str(cr3))

    crw = tmp_path / "shot.crw"
    crw.write_bytes(b"II\x1a\x00\x00\x00HEAPCCDR" + b"\0" * 64)
    with pytest.raises(ValueError, match="CIFF"):
        decode_file(str(crw))

    # X3F decodes natively now (test_x3f.py); a malformed Foveon file
    # still fails with the container problem named, not a PIL error.
    x3f = tmp_path / "shot.x3f"
    x3f.write_bytes(b"FOVb" + b"\0" * 64)
    with pytest.raises(ValueError, match="X3F"):
        decode_file(str(x3f))

    # IIQ decodes natively now (test_iiq.py); a malformed Phase One file
    # still fails with the parse problem named, not a PIL error.
    iiq = tmp_path / "shot.iiq"
    iiq.write_bytes(b"IIII" + b"\0" * 64)
    with pytest.raises(ValueError, match="IIQ"):
        decode_file(str(iiq))

    # SRF decodes natively now (test_srf.py); unknown Sony models still
    # refuse with the geometry gap named.
    srf = tmp_path / "shot.srf"
    srf.write_bytes(b"II*\x00" + b"\0" * 64)
    with pytest.raises(ValueError, match="SRF|decode"):
        decode_file(str(srf))


def test_vendor_levels_registry(tmp_path):
    from imagepipe_tpu.vendor import register_vendor_levels

    data = _sensor(8, 32, seed=37)
    register_vendor_levels("PENTAX K-70", 64, 16000)
    path = str(tmp_path / "k70.pef")
    with open(path, "wb") as f:
        f.write(make_pef(data, model="PENTAX K-70"))
    from imagepipe_tpu.vendor import read_pef

    raw = read_pef(path)
    assert raw.blacklevels == (64,) * 4
    assert raw.whitelevels == (16000,) * 4


def make_cr2_sraw(Y, Cb, Cr, model="Canon EOS 5D Mark II",
                  wb=(2100, 1024, 1024, 1400), precision=15) -> bytes:
    """sRAW/mRAW CR2: subsampled 3-component YCbCr lossless JPEG."""
    from imagepipe_tpu.lj92 import encode_sraw

    payload = encode_sraw(Y, Cb, Cr, precision=precision)
    b = TiffBuilder("<", header_extra=b"CR\x02\x00")
    strip = b.add_blob(payload)
    colordata = [0] * 1312
    colordata[63:67] = list(wb)
    note_ifd = b.add_ifd([(0x4001, 3, colordata)], chain=False)
    exif_ifd = b.add_ifd([(37500, 7, ("ptr", 256, note_ifd))], chain=False)
    b.add_ifd([
        (271, 2, "Canon"), (272, 2, model), (274, 3, [1]),
        (34665, 4, [exif_ifd]),
    ])
    b.add_ifd([(259, 3, [6]), (273, 4, [strip]), (279, 4, [len(payload)])])
    return b.bytes()


def _sraw_oracle(Y, Cb, Cr, precision):
    """Independent scalar reconstruction: replicate-then-midpoint chroma
    upsample and the dcraw-semantics >>14 integer matrix."""
    vs = Y.shape[0] // Cb.shape[0]
    hs = Y.shape[1] // Cb.shape[1]
    H, W = Y.shape
    bias = 1 << (precision - 1)
    maxv = (1 << precision) - 1
    out = np.zeros((H, W, 3), np.int64)
    for y in range(H):
        for x in range(W):
            my, ry = divmod(y, vs)
            mx, rx = divmod(x, hs)

            def up(p):
                v0 = int(p[my, mx])
                if ry and my + 1 < p.shape[0]:
                    v0 = (v0 + int(p[my + 1, mx])) >> 1
                if rx and mx + 1 < p.shape[1]:
                    v1 = int(p[min(my + (1 if ry and my + 1 < p.shape[0] else 0), p.shape[0]-1), mx + 1])
                    pass
                return v0

            # vertical midpoint first, then horizontal midpoint -- exactly
            # _chroma_upsample's order.
            def up2(p):
                a = int(p[my, mx])
                if ry:
                    a = (a + int(p[min(my + 1, p.shape[0] - 1), mx])) >> 1
                if rx:
                    b_ = int(p[my, min(mx + 1, p.shape[1] - 1)])
                    if ry:
                        b_ = (b_ + int(p[min(my + 1, p.shape[0] - 1),
                                         min(mx + 1, p.shape[1] - 1)])) >> 1
                    a = (a + b_) >> 1
                return a

            cb = up2(Cb) - bias
            cr = up2(Cr) - bias
            yv = int(Y[y, x])
            out[y, x, 0] = yv + ((50 * cb + 22929 * cr) >> 14)
            out[y, x, 1] = yv + ((-5640 * cb - 11751 * cr) >> 14)
            out[y, x, 2] = yv + ((29040 * cb - 101 * cr) >> 14)
    return np.clip(out, 0, maxv).astype(np.uint16)


@pytest.mark.parametrize("vs", [1, 2])
def test_cr2_sraw_decode(tmp_path, vs):
    rng = np.random.default_rng(7 + vs)
    H, W = 16 * vs, 24
    # smooth-ish luma + chroma around the bias point (realistic sRAW)
    Y = (8000 + np.cumsum(rng.integers(-50, 50, (H, W)), axis=1)).astype(np.uint16)
    Cb = rng.integers(16000, 17000, (H // vs, W // 2)).astype(np.uint16)
    Cr = rng.integers(16000, 17000, (H // vs, W // 2)).astype(np.uint16)
    path = str(tmp_path / "shot.cr2")
    with open(path, "wb") as f:
        f.write(make_cr2_sraw(Y, Cb, Cr))
    from imagepipe_tpu.decode import codec_family

    assert codec_family(path) == "cr2-sraw"
    src = decode_file(path)
    raw = src.raw
    assert raw.cpp == 3 and (raw.width, raw.height) == (W, H)
    assert raw.whitelevels[0] == (1 << 15) - 1
    want = _sraw_oracle(Y, Cb, Cr, 15)
    np.testing.assert_array_equal(
        raw.data.reshape(H, W, 3), want)
    assert raw.wb_coeffs[0] == pytest.approx(2100.0)
    # end-to-end develop through the rgb mode
    out = Pipeline.new_from_source(src).output_8bit(None)
    assert out.data.shape == (H, W, 3)


def test_cr2_sraw_fullsize_unaffected(tmp_path):
    # a 2-component (CFA) CR2 still takes the mosaic path
    data = _sensor(16, 32, seed=9)
    path = str(tmp_path / "full.cr2")
    with open(path, "wb") as f:
        f.write(make_cr2(data))
    from imagepipe_tpu.decode import codec_family

    assert codec_family(path) == "cr2-lj92"
    raw = decode_file(path).raw
    assert raw.cpp == 1
    np.testing.assert_array_equal(raw.data, data)
