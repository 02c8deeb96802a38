"""Decode layer tests: DNG read/write round-trip, packed-bitstream unpackers
(native vs numpy fallback), PGM, and the decoder registry."""

import struct

import numpy as np
import pytest

from imagepipe_tpu import native
from imagepipe_tpu.dng import read_dng, write_dng
from imagepipe_tpu.raw import CFA, Orientation, synthetic_bayer


def _pack_12be(vals):
    out = bytearray()
    for i in range(0, len(vals), 2):
        p0 = int(vals[i])
        p1 = int(vals[i + 1]) if i + 1 < len(vals) else 0
        out += bytes([(p0 >> 4) & 0xFF, ((p0 & 0xF) << 4) | (p1 >> 8), p1 & 0xFF])
    return np.frombuffer(bytes(out), np.uint8)


def _pack_12le(vals):
    out = bytearray()
    for i in range(0, len(vals), 2):
        p0 = int(vals[i])
        p1 = int(vals[i + 1]) if i + 1 < len(vals) else 0
        out += bytes([p0 & 0xFF, ((p1 & 0xF) << 4) | (p0 >> 8), (p1 >> 4) & 0xFF])
    return np.frombuffer(bytes(out), np.uint8)


def _pack_14be(vals):
    bits = "".join(format(int(v), "014b") for v in vals)
    bits += "0" * (-len(bits) % 8)
    return np.frombuffer(bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8)), np.uint8)


def test_unpack_12be():
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 4096, 101, np.uint16)
    got = native.unpack_12be(_pack_12be(vals), len(vals))
    np.testing.assert_array_equal(got, vals)


def test_unpack_12le():
    rng = np.random.default_rng(1)
    vals = rng.integers(0, 4096, 101, np.uint16)
    got = native.unpack_12le(_pack_12le(vals), len(vals))
    np.testing.assert_array_equal(got, vals)


def test_unpack_14be():
    rng = np.random.default_rng(2)
    vals = rng.integers(0, 16384, 103, np.uint16)
    got = native.unpack_14be(_pack_14be(vals), len(vals))
    np.testing.assert_array_equal(got, vals)


def test_swap_16be():
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 65536, 57, np.uint16)
    got = native.swap_16be(np.frombuffer(vals.astype(">u2").tobytes(), np.uint8), len(vals))
    np.testing.assert_array_equal(got, vals)


def test_dng_roundtrip(tmp_path):
    raw = synthetic_bayer(64, 48, seed=5)
    raw.crops = (2, 4, 2, 4)
    path = str(tmp_path / "shot.dng")
    write_dng(path, raw)
    back = read_dng(path)
    assert (back.width, back.height) == (raw.width, raw.height)
    np.testing.assert_array_equal(np.asarray(back.data), np.asarray(raw.data))
    assert back.cfa.name == raw.cfa.name
    assert back.crops == raw.crops
    assert back.blacklevels == raw.blacklevels
    assert back.whitelevels[0] == raw.whitelevels[0]
    # ColorMatrix quantized to 1e-4 rationals.
    np.testing.assert_allclose(back.xyz_to_cam[:3], raw.xyz_to_cam[:3], atol=1e-4)
    # wb coeffs recovered from AsShotNeutral up to normalization.
    got = np.array(back.wb_coeffs[:3]) / back.wb_coeffs[1]
    want = np.array(raw.wb_coeffs[:3]) / raw.wb_coeffs[1]
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert back.orientation == raw.orientation


def test_dng_through_pipeline(tmp_path):
    from imagepipe_tpu import Pipeline, simple_decode_8bit, ImageSource

    raw = synthetic_bayer(96, 64, seed=6)
    path = str(tmp_path / "shot.dng")
    write_dng(path, raw)
    out = simple_decode_8bit(path)
    assert (out.width, out.height) == (96, 64)
    # Same data via direct source: equal output (up to wb rational rounding).
    direct = Pipeline.new_from_source(ImageSource.from_raw(raw)).output_8bit(None)
    diff = out.data.astype(int) - direct.data.astype(int)
    assert np.abs(diff).max() <= 1


def test_pgm16_decode(tmp_path):
    from imagepipe_tpu.decode import decode_file

    h, w = 12, 16
    vals = (np.arange(h * w, dtype=np.uint16) * 97) % 65535
    path = tmp_path / "dump.pgm"
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n65535\n" % (w, h))
        f.write(vals.astype(">u2").tobytes())
    src = decode_file(str(path))
    assert src.is_raw
    np.testing.assert_array_equal(np.asarray(src.raw.data), vals.reshape(h, w))
    assert src.raw.cfa.name == "RGGB"


def test_lj92_roundtrip_native_and_python():
    from imagepipe_tpu import lj92

    rng = np.random.default_rng(11)
    for (h, w), ncomp in [((16, 24), 1), ((33, 17), 1), ((8, 24), 2)]:
        img = rng.integers(0, 65536, (h, w * ncomp), np.uint16)
        stream = lj92.encode(img, ncomp=ncomp, precision=16)
        np.testing.assert_array_equal(lj92._decode_python(stream), img)
        if native.have_native():
            np.testing.assert_array_equal(lj92._decode_native(stream), img)
    # Smooth data must actually compress (predictor + Huffman working).
    smooth = (np.outer(np.arange(64), np.ones(64)) * 16 + 512).astype(np.uint16)
    stream = lj92.encode(smooth)
    assert len(stream) < smooth.nbytes // 4
    np.testing.assert_array_equal(lj92.decode(stream), smooth)


def test_lj92_stream_fuzz_never_hangs(tmp_path):
    """Truncated/corrupted lossless-JPEG streams must raise or decode in
    bounded time -- both the python and (when built) native decoders; the
    bit reader and Huffman walker must never spin or crash."""
    from imagepipe_tpu import lj92
    from imagepipe_tpu import native

    rng = np.random.default_rng(23)
    img = rng.integers(0, 1 << 14, (24, 32), np.uint16)
    good = lj92.encode(img, ncomp=1, precision=14)
    decoders = [lj92._decode_python]
    if native.have_native() and hasattr(native._lib, "lj92_decode"):
        decoders.append(lj92._decode_native)
    for i in range(40):
        bad = bytearray(good)
        for _ in range(int(rng.integers(1, 5))):
            bad[int(rng.integers(2, len(bad)))] = int(rng.integers(0, 256))
        if rng.random() < 0.5:
            bad = bad[:int(rng.integers(4, len(bad)))]
        for dec in decoders:
            try:
                dec(bytes(bad))
            except (ValueError, AssertionError, IndexError, struct.error):
                pass  # clean rejection is fine; hanging/segfault is not


def test_lj92_malformed_streams_rejected():
    """Three crafted streams that previously crashed or hit UB in the
    native decoder (found by an ASan review pass): a DHT whose declared
    segment length overruns the buffer, a DHT whose counts oversubscribe
    the canonical code space (heap overflow in the LUT build), and a
    valid table whose leaf value is not a T.81 lossless category
    (ssss=40 reached 1<<39). All must raise cleanly in BOTH decoders."""
    from imagepipe_tpu import lj92
    from imagepipe_tpu import native

    sof_sos = (b"\xff\xc3\x00\x08\x0e\x00\x04\x00\x04\x01"
               b"\xff\xda\x00\x08\x01\x00\x00\x01\x00\x00")

    trunc_dht = b"\xff\xd8\xff\xc4\xff\xff"

    nvals = 255
    seglen = 2 + 17 + nvals
    oversub = (b"\xff\xd8\xff\xc4" + bytes([seglen >> 8, seglen & 0xFF])
               + b"\x00" + bytes([255]) + b"\x00" * 15
               + bytes(range(nvals)) + sof_sos)

    ssss40 = (b"\xff\xd8\xff\xc4\x00\x14\x00" + bytes([1]) + b"\x00" * 15
              + bytes([40]) + sof_sos + b"\x00" * 8)

    for blob in (trunc_dht, oversub, ssss40):
        # The NATIVE decoder must REJECT these (a silent success would
        # mean the bounds/validity guards regressed -- the heap overflow
        # corrupts memory without raising when ASan isn't loaded).
        if native.have_native() and hasattr(native._lib, "lj92_decode"):
            with pytest.raises(ValueError):
                lj92._decode_native(blob)
        # The python walker has big-int semantics and may decode garbage
        # instead; it just must terminate without an unexpected crash.
        try:
            lj92._decode_python(blob)
        except (ValueError, AssertionError, IndexError, KeyError,
                struct.error):
            pass


def test_dng_lossless_jpeg_roundtrip(tmp_path):
    raw = synthetic_bayer(64, 48, seed=8)
    path = str(tmp_path / "shot_lj.dng")
    write_dng(path, raw, compression=7)
    back = read_dng(path)
    np.testing.assert_array_equal(np.asarray(back.data), np.asarray(raw.data))
    assert back.cfa.name == raw.cfa.name

    # A larger, smoother frame must actually compress (predictor working
    # across the 2-component CFA interleave).
    import os

    big = synthetic_bayer(512, 384, seed=9)
    big.data = (big.data // 64 * 64).astype(np.uint16)  # quantize -> smoother
    path2 = str(tmp_path / "big_lj.dng")
    write_dng(path2, big, compression=7)
    back2 = read_dng(path2)
    np.testing.assert_array_equal(np.asarray(back2.data), np.asarray(big.data))
    assert os.path.getsize(path2) < big.data.nbytes


def test_dng_tiled_layout(tmp_path):
    """Tiled DNG reading (the common layout for compressed camera DNGs):
    hand-assemble a 2x2-tile file and check reassembly + LJ92 tiles."""
    import struct
    from imagepipe_tpu import lj92

    h, w, tl, tw = 20, 24, 12, 16  # tiles: 2 rows x 2 cols, padded
    rng = np.random.default_rng(21)
    img = rng.integers(0, 65535, (h, w), np.uint16)

    tiles = []
    for ty in range(2):
        for tx in range(2):
            tile = np.zeros((tl, tw), np.uint16)
            ys, xs = ty * tl, tx * tw
            sub = img[ys:min(h, ys + tl), xs:min(w, xs + tw)]
            tile[:sub.shape[0], :sub.shape[1]] = sub
            tiles.append(lj92.encode(tile, ncomp=1, precision=16))

    # Minimal TIFF: header + IFD + tile data.
    entries = []

    def add(tag, typ, vals):
        entries.append((tag, typ, vals))

    add(256, 4, [w]); add(257, 4, [h]); add(258, 3, [16]); add(259, 3, [7])
    add(262, 3, [32803]); add(277, 3, [1])
    add(322, 4, [tw]); add(323, 4, [tl])
    add(33421, 3, [2, 2]); add(33422, 1, [0, 1, 1, 2])
    add(324, 4, [0, 0, 0, 0])  # patched
    add(325, 4, [len(t) for t in tiles])
    entries.sort(key=lambda e: e[0])

    def pack_vals(typ, vals):
        fmt = {3: "H", 4: "I", 1: "B"}[typ]
        pre = "<" if typ != 1 else ""
        return struct.pack(f"{pre}{len(vals)}{fmt}", *vals)

    n = len(entries)
    ifd_off = 8
    ext_off = ifd_off + 2 + n * 12 + 4
    ext = bytearray()
    packed = []
    for tag, typ, vals in entries:
        b = pack_vals(typ, vals)
        if len(b) <= 4:
            packed.append((tag, typ, len(vals), b.ljust(4, b"\0"), None))
        else:
            packed.append((tag, typ, len(vals), None, ext_off + len(ext)))
            ext += b
    data_off = ext_off + len(ext)
    offs = []
    pos = data_off
    for t in tiles:
        offs.append(pos)
        pos += len(t)

    out = bytearray(struct.pack("<2sHI", b"II", 42, ifd_off))
    out += struct.pack("<H", n)
    for tag, typ, count, inline, off in packed:
        if tag == 324:
            b = struct.pack("<4I", *offs)
            # 4 offsets > 4 bytes: point into ext
            out += struct.pack("<HHII", tag, typ, count, ext_off + len(ext))
            ext += b
            continue
        if inline is not None:
            out += struct.pack("<HHI", tag, typ, count) + inline
        else:
            out += struct.pack("<HHII", tag, typ, count, off)
    out += struct.pack("<I", 0)
    # ext grew after data_off was computed; rebuild data offsets accordingly
    data_off2 = ifd_off + 2 + n * 12 + 4 + len(ext)
    delta = data_off2 - data_off
    if delta:
        b = struct.pack("<4I", *[o + delta for o in offs])
        ext[-16:] = b
    out += ext
    for t in tiles:
        out += t
    path = tmp_path / "tiled.dng"
    path.write_bytes(bytes(out))

    back = read_dng(str(path))
    np.testing.assert_array_equal(np.asarray(back.data), img)
    assert back.cfa.name == "RGGB"


def test_dng_xtrans_roundtrip(tmp_path):
    """6x6 CFA (X-Trans) DNG round-trip: 36-char CFAPattern tag."""
    from imagepipe_tpu.raw import synthetic_xtrans

    raw = synthetic_xtrans(72, 48, seed=30)
    path = str(tmp_path / "xt.dng")
    write_dng(path, raw, compression=1)
    back = read_dng(path)
    np.testing.assert_array_equal(np.asarray(back.data), np.asarray(raw.data))
    assert back.cfa.name == raw.cfa.name
    assert (back.cfa.height, back.cfa.width) == (6, 6)


def test_dng_12bit_packed(tmp_path):
    """12-bit packed (TIFF FillOrder=1) DNG strips through the native
    unpacker -- the most common in-camera bit depth."""
    import struct

    h, w = 8, 16
    rng = np.random.default_rng(33)
    img = rng.integers(0, 4096, (h, w), np.uint16)
    payload = bytes(_pack_12be(img.ravel()))

    entries = [
        (256, 4, [w]), (257, 4, [h]), (258, 3, [12]), (259, 3, [1]),
        (262, 3, [32803]), (273, 4, [0]), (277, 3, [1]), (278, 4, [h]),
        (279, 4, [len(payload)]),
        (33421, 3, [2, 2]), (33422, 1, [0, 1, 1, 2]),
        (50717, 3, [4095]),
    ]
    entries.sort(key=lambda e: e[0])

    def pack_vals(typ, vals):
        fmt = {3: "H", 4: "I", 1: "B"}[typ]
        return struct.pack(f"<{len(vals)}{fmt}", *vals)

    n = len(entries)
    data_off = 8 + 2 + n * 12 + 4
    out = bytearray(struct.pack("<2sHI", b"II", 42, 8))
    out += struct.pack("<H", n)
    for tag, typ, vals in entries:
        b = pack_vals(typ, vals)
        if tag == 273:
            b = struct.pack("<I", data_off)
        assert len(b) <= 4
        out += struct.pack("<HHI", tag, typ, len(vals)) + b.ljust(4, b"\0")
    out += struct.pack("<I", 0)
    out += payload
    path = tmp_path / "p12.dng"
    path.write_bytes(bytes(out))

    back = read_dng(str(path))
    np.testing.assert_array_equal(np.asarray(back.data), img)
    assert back.whitelevels[0] == 4095


def test_pil_16bit_to_rgb8_narrows(tmp_path):
    """PIL 16-bit payloads must narrow by >>8, not clip at 255 (regression:
    convert('RGB') clipped everything to white)."""
    from PIL import Image
    from imagepipe_tpu.sources import RasterImage

    arr = (np.arange(20 * 30, dtype=np.uint32).reshape(20, 30) * 97 % 65535)
    img = Image.fromarray(arr.astype(np.uint16), mode="I;16")
    r = RasterImage(img)
    got = r.to_rgb8()
    want = (arr >> 8).astype(np.uint8)
    np.testing.assert_array_equal(got[..., 0], want)


def test_pgm_truncated_header_raises(tmp_path):
    """Truncated PGM header must raise, not hang (regression: EOF loop)."""
    from imagepipe_tpu.decode import _decode_pgm16

    path = tmp_path / "trunc.pgm"
    path.write_bytes(b"P5\n")
    with pytest.raises(ValueError):
        _decode_pgm16(str(path))


def test_lj92_restart_interval_roundtrip():
    """DRI/RSTn streams: prediction must reset per interval (T.81)."""
    from imagepipe_tpu import lj92

    rng = np.random.default_rng(42)
    img = rng.integers(0, 65536, (23, 17), np.uint16)
    stream = lj92.encode(img, ncomp=1, precision=16, restart_rows=5)
    assert b"\xff\xdd" in stream  # DRI present
    np.testing.assert_array_equal(lj92._decode_python(stream), img)
    if native.have_native():
        np.testing.assert_array_equal(lj92._decode_native(stream), img)


def test_cfa_explicit_dims():
    """CFARepeatPatternDim must override length-based inference."""
    name = "RGGB" * 4  # 16 entries
    c_2x8 = CFA(name, height=2, width=8)
    c_4x4 = CFA(name, height=4, width=4)
    default = CFA(name)
    assert (c_2x8.height, c_2x8.width) == (2, 8)
    assert (c_4x4.height, c_4x4.width) == (4, 4)
    assert (default.height, default.width) == (2, 8)
    assert c_4x4.color_at(2, 0) == 0  # row 2 of 4x4 starts with R
    with pytest.raises(ValueError):
        CFA(name, height=3, width=4)


def _dng_builder_ifd(entries_extra, data_payload, w, h, bits=16, endian="<",
                     sample_format=None, compression=1):
    """Minimal single-IFD DNG via tiffgen for robustness tests."""
    from tiffgen import TiffBuilder

    b = TiffBuilder(endian)
    strip = b.add_blob(data_payload)
    entries = [
        (256, 4, [w]), (257, 4, [h]), (258, 3, [bits]), (259, 3, [compression]),
        (262, 3, [32803]), (273, 4, [strip]), (278, 4, [h]),
        (279, 4, [len(data_payload)]),
        (33421, 3, [2, 2]), (33422, 1, [0, 1, 1, 2]),
    ]
    if sample_format is not None:
        entries.append((339, 3, [sample_format]))
    entries.extend(entries_extra)
    b.add_ifd(entries)
    return b.bytes()


def test_dng_float_payload(tmp_path):
    """32-bit float DNG (SampleFormat 3): payload decodes as f32 and the
    pipeline's float-RAW path (gofloat.rs:132-167 semantics) develops it."""
    from imagepipe_tpu import ImageSource, Pipeline

    rng = np.random.default_rng(9)
    h, w = 24, 32
    data = rng.uniform(0.0, 1.0, (h, w)).astype(np.float32)
    blob = _dng_builder_ifd([(50717, 3, [1])], data.astype("<f4").tobytes(),
                            w, h, bits=32, sample_format=3)
    path = str(tmp_path / "f.dng")
    with open(path, "wb") as f:
        f.write(blob)
    raw = read_dng(path)
    assert raw.data.dtype == np.float32
    np.testing.assert_array_equal(raw.data, data)
    Pipeline.new_from_source(ImageSource.from_raw(raw)).output_8bit(None)


def test_dng_linearization_table(tmp_path):
    """LinearizationTable maps raw counts through the LUT at decode."""
    h, w = 8, 16
    data = np.arange(h * w, dtype=np.uint16).reshape(h, w) % 256
    lut = (np.arange(256, dtype=np.uint16) * 3) % 4096
    blob = _dng_builder_ifd([(50712, 3, list(lut))],
                            data.astype("<u2").tobytes(), w, h)
    path = str(tmp_path / "lin.dng")
    with open(path, "wb") as f:
        f.write(blob)
    raw = read_dng(path)
    np.testing.assert_array_equal(raw.data, lut[data])


def test_dng_black_level_repeat_dim(tmp_path):
    h, w = 8, 16
    data = np.zeros((h, w), np.uint16)
    # 2x2 pattern: row-major RGGB-cell blacks.
    blob = _dng_builder_ifd(
        [(50713, 3, [2, 2]), (50714, 3, [64, 65, 66, 67])],
        data.astype("<u2").tobytes(), w, h)
    path = str(tmp_path / "blr.dng")
    with open(path, "wb") as f:
        f.write(blob)
    assert read_dng(path).blacklevels == (64, 65, 66, 67)
    # Unsupported repeat dims are rejected with a clear error.
    blob = _dng_builder_ifd(
        [(50713, 3, [4, 2]), (50714, 3, [1, 2, 3, 4, 5, 6, 7, 8])],
        data.astype("<u2").tobytes(), w, h)
    path = str(tmp_path / "blr2.dng")
    with open(path, "wb") as f:
        f.write(blob)
    with pytest.raises(ValueError, match="BlackLevelRepeatDim"):
        read_dng(path)


def test_dng_garbage_secondary_ifd_pointer_still_decodes(tmp_path):
    """A trailing next-IFD pointer past EOF (common in files rewritten by
    editing tools) must not fail the decode: the walker skips broken
    SECONDARY chains and keeps the raw IFD; a broken primary IFD is still
    a hard error."""
    import struct as _struct

    raw = synthetic_bayer(32, 24, seed=21)
    good = str(tmp_path / "good.dng")
    write_dng(good, raw)
    blob = bytearray(open(good, "rb").read())
    (first,) = _struct.unpack_from("<I", blob, 4)
    nentries = _struct.unpack_from("<H", blob, first)[0]
    # Point the next-IFD pointer way past EOF.
    _struct.pack_into("<I", blob, first + 2 + nentries * 12, len(blob) + 99999)
    p = str(tmp_path / "badnext.dng")
    with open(p, "wb") as f:
        f.write(bytes(blob))
    got = read_dng(p)
    np.testing.assert_array_equal(got.data, np.asarray(raw.data))


def test_dng_ifd_fuzz_truncation_and_loops(tmp_path):
    """Malformed DNGs -- truncations at every interesting boundary, an IFD
    chain that loops, offsets past EOF -- must raise ValueError, never hang
    or crash (the tiff.py walker contract)."""
    import struct as _struct

    raw = synthetic_bayer(32, 24, seed=13)
    good_path = str(tmp_path / "good.dng")
    write_dng(good_path, raw)
    blob = open(good_path, "rb").read()

    rng = np.random.default_rng(0)
    cuts = [4, 9, 12, 25, 50, 100, len(blob) // 2] + list(
        rng.integers(4, len(blob) - 1, 20))
    for i, cut in enumerate(cuts):
        p = str(tmp_path / f"cut{i}.dng")
        with open(p, "wb") as f:
            f.write(blob[:int(cut)])
        try:
            read_dng(p)
        except ValueError:
            pass  # expected failure mode

    # Self-looping IFD chain: next-IFD pointer points back at the first IFD.
    looped = bytearray(blob)
    (first,) = _struct.unpack_from("<I", looped, 4)
    nentries = _struct.unpack_from("<H", looped, first)[0]
    _struct.pack_into("<I", looped, first + 2 + nentries * 12, first)
    p = str(tmp_path / "loop.dng")
    with open(p, "wb") as f:
        f.write(bytes(looped))
    raw2 = read_dng(p)  # loop is detected and ignored; file still decodes
    np.testing.assert_array_equal(raw2.data, np.asarray(raw.data))

    # A chain of fresh IFDs each pointing deeper (offset bomb) must hit the
    # walker's IFD-count limit, not spin.
    bomb = bytearray(blob)
    _struct.pack_into("<I", bomb, first + 2 + nentries * 12, len(bomb))
    for i in range(200):
        off = len(bomb)
        bomb += _struct.pack("<H", 0)  # 0 entries
        nxt = off + 6 if i < 199 else 0
        bomb += _struct.pack("<I", nxt)
    p = str(tmp_path / "bomb.dng")
    with open(p, "wb") as f:
        f.write(bytes(bomb))
    with pytest.raises(ValueError, match="IFD count"):
        read_dng(p)


# ---------------------------------------------------------------------------
# DNG Deflate (compression 8, DNG 1.4) — reference surface: rawloader's DNG
# decoder behind /root/reference/src/pipeline.rs:264 handles the same
# Adobe-written deflate shapes.
# ---------------------------------------------------------------------------


def test_dng_deflate_integer_roundtrip(tmp_path):
    """16-bit CFA Deflate round-trip at every supported predictor."""
    raw = synthetic_bayer(64, 48, seed=21)
    for pred in (None, 1, 2):
        path = str(tmp_path / f"z{pred}.dng")
        write_dng(path, raw, compression=8, predictor=pred)
        back = read_dng(path)
        np.testing.assert_array_equal(np.asarray(back.data),
                                      np.asarray(raw.data))
        assert back.cfa.name == raw.cfa.name
        assert back.blacklevels == raw.blacklevels


def test_dng_deflate_float_roundtrip(tmp_path):
    """Float32 (HDR-shape) DNG: SampleFormat 3 + Deflate, predictors 1/3."""
    base = synthetic_bayer(64, 48, seed=22)
    rng = np.random.default_rng(22)
    fdata = (rng.uniform(0.0, 1.0, (48, 64)).astype(np.float32)
             * np.float32(4.7))
    import dataclasses
    raw = dataclasses.replace(base, data=fdata, blacklevels=(0, 0, 0, 0),
                              whitelevels=(1, 1, 1, 1))
    for pred in (None, 1, 3):
        path = str(tmp_path / f"f{pred}.dng")
        write_dng(path, raw, compression=8, predictor=pred)
        back = read_dng(path)
        assert back.data.dtype == np.float32
        np.testing.assert_array_equal(np.asarray(back.data), fdata)
    # Uncompressed float writer path too.
    path = str(tmp_path / "fu.dng")
    write_dng(path, raw, compression=1)
    np.testing.assert_array_equal(np.asarray(read_dng(path).data), fdata)


def test_dng_deflate_reader_vs_pil_encoder(tmp_path):
    """Independent-oracle direction 1: PIL's libtiff-free TIFF encoder
    produces the deflate streams; our reader must reproduce PIL's pixels
    for both 16-bit integer and float32 payloads."""
    from PIL import Image

    rng = np.random.default_rng(23)
    a16 = rng.integers(0, 65536, (40, 56), dtype=np.uint16)
    p16 = str(tmp_path / "pil16.tif")
    Image.fromarray(a16).save(p16, format="TIFF",
                              compression="tiff_adobe_deflate")
    back = read_dng(p16)  # non-CFA TIFF: largest-main-image fallback
    np.testing.assert_array_equal(np.asarray(back.data), a16)

    af = rng.uniform(-2.0, 2.0, (40, 56)).astype(np.float32)
    pf = str(tmp_path / "pilf.tif")
    Image.fromarray(af, mode="F").save(pf, format="TIFF",
                                       compression="tiff_adobe_deflate")
    backf = read_dng(pf)
    assert backf.data.dtype == np.float32
    np.testing.assert_array_equal(np.asarray(backf.data), af)


def test_dng_deflate_writer_vs_pil_decoder(tmp_path):
    """Independent-oracle direction 2: our predictor-2/3 ENCODED strips,
    relabeled with a PIL-readable photometric, must decode identically in
    PIL (whose TIFF reader undoes both predictors itself)."""
    from PIL import Image
    from imagepipe_tpu.tiff import TiffFile

    def strip_as_classic_tiff(dng_path, w, h, bits, pred, sfmt):
        with open(dng_path, "rb") as f:
            buf = f.read()
        ifd = TiffFile(buf).ifds[0]
        (off,), (cnt,) = ifd.get(273), ifd.get(279)
        payload = buf[off:off + cnt]
        from tiffgen import TiffBuilder

        b = TiffBuilder("<")
        strip = b.add_blob(payload)
        b.add_ifd([(256, 4, [w]), (257, 4, [h]), (258, 3, [bits]),
                   (259, 3, [8]), (262, 3, [1]), (273, 4, [strip]),
                   (277, 3, [1]), (278, 4, [h]), (279, 4, [len(payload)]),
                   (317, 3, [pred]), (339, 3, [sfmt])])
        return b.bytes()

    raw = synthetic_bayer(64, 48, seed=24)
    pi = str(tmp_path / "ours_i.dng")
    write_dng(pi, raw, compression=8)  # predictor 2
    blob = strip_as_classic_tiff(pi, 64, 48, 16, 2, 1)
    p = str(tmp_path / "ours_i.tif")
    with open(p, "wb") as f:
        f.write(blob)
    got = np.array(Image.open(p)).astype(np.uint16)
    np.testing.assert_array_equal(got, np.asarray(raw.data))

    rng = np.random.default_rng(24)
    fdata = rng.uniform(0.0, 3.0, (48, 64)).astype(np.float32)
    import dataclasses
    fraw = dataclasses.replace(raw, data=fdata, blacklevels=(0, 0, 0, 0),
                               whitelevels=(1, 1, 1, 1))
    pf = str(tmp_path / "ours_f.dng")
    write_dng(pf, fraw, compression=8)  # predictor 3
    blobf = strip_as_classic_tiff(pf, 64, 48, 32, 3, 3)
    p2 = str(tmp_path / "ours_f.tif")
    with open(p2, "wb") as f:
        f.write(blobf)
    gotf = np.array(Image.open(p2))
    np.testing.assert_array_equal(gotf, fdata)


def test_dng_fp16_payloads(tmp_path):
    """fp16 float DNGs (common HDR-merge output): uncompressed and
    Deflate+predictor-3 streams decode, widened to f32."""
    import zlib

    rng = np.random.default_rng(25)
    h, w = 24, 32
    f16 = rng.uniform(0.0, 1.0, (h, w)).astype(np.float16)
    blob = _dng_builder_ifd([(50717, 3, [1])], f16.astype("<f2").tobytes(),
                            w, h, bits=16, sample_format=3)
    p = str(tmp_path / "h.dng")
    with open(p, "wb") as f:
        f.write(blob)
    raw = read_dng(p)
    assert raw.data.dtype == np.float32
    np.testing.assert_array_equal(np.asarray(raw.data), f16.astype(np.float32))

    # Deflate + predictor 3 on fp16: 2-byte MSB-first planes.
    be = f16.astype(">f2").view(np.uint8).reshape(h, w, 2)
    rowsb = np.moveaxis(be, 2, 1).reshape(h, 2 * w).astype(np.int16)
    rowsb[:, 1:] = (rowsb[:, 1:] - rowsb[:, :-1]) & 0xFF
    payload = zlib.compress(rowsb.astype(np.uint8).tobytes())
    blob2 = _dng_builder_ifd([(50717, 3, [1]), (317, 3, [3])], payload,
                             w, h, bits=16, sample_format=3, compression=8)
    p2 = str(tmp_path / "hz.dng")
    with open(p2, "wb") as f:
        f.write(blob2)
    raw2 = read_dng(p2)
    np.testing.assert_array_equal(np.asarray(raw2.data), f16.astype(np.float32))


def test_dng_deflate_rejects_bad_streams(tmp_path):
    """Named refusals: corrupt deflate bytes, truncated inflated payload,
    DNG-1.4 predictor codes, predictor/sample-format mismatches."""
    import zlib

    w, h = 32, 24
    good = np.arange(h * w, dtype=np.uint16).reshape(h, w)

    def build(payload, extra, **kw):
        return _dng_builder_ifd([(50717, 3, [65535])] + extra, payload,
                                w, h, compression=8, **kw)

    def expect(blob, match):
        p = str(tmp_path / "x.dng")
        with open(p, "wb") as f:
            f.write(blob)
        with pytest.raises(ValueError, match=match):
            read_dng(p)

    expect(build(b"\x00not-deflate", []), "corrupt Deflate")
    short = zlib.compress(good.astype("<u2").tobytes()[:100])
    expect(build(short, [(317, 3, [2])]), "truncated inflated")
    ok = zlib.compress(good.astype("<u2").tobytes())
    expect(build(ok, [(317, 3, [34892])]), "Predictor 34892")
    expect(build(ok, [(317, 3, [3])]), "Predictor 3 on integer")
    fpay = zlib.compress(good.astype("<f4").tobytes())
    expect(build(fpay, [(317, 3, [2])], bits=32, sample_format=3),
           "Predictor 2 supported only")
    # Predictor on a non-deflate container is refused too.
    expect(_dng_builder_ifd([(50717, 3, [65535]), (317, 3, [2])],
                            good.astype("<u2").tobytes(), w, h),
           "Deflate only")


def test_dng_deflate_through_pipeline(tmp_path):
    """A deflate CFA DNG develops end-to-end identically to its
    uncompressed twin."""
    from imagepipe_tpu import simple_decode_8bit

    raw = synthetic_bayer(64, 48, seed=26)
    pz = str(tmp_path / "z.dng")
    pu = str(tmp_path / "u.dng")
    write_dng(pz, raw, compression=8)
    write_dng(pu, raw, compression=1)
    np.testing.assert_array_equal(simple_decode_8bit(pz).data,
                                  simple_decode_8bit(pu).data)


def test_codec_family_labels(tmp_path):
    """codec_family (the real-file audit axis) labels every synthesized
    container with its decoder family without decoding pixels."""
    import struct

    import numpy as np

    from imagepipe_tpu.decode import codec_family
    from test_rw2 import make_rw2, _smooth
    from test_nikon import make_nef_34713, _rng
    from test_raf import make_raf, make_raf_tiff, _sensor
    from imagepipe_tpu.rw2 import (encode_panasonic_v5, encode_panasonic_v6,
                                   encode_panasonic_v7)

    def put(name, blob):
        p = str(tmp_path / name)
        with open(p, "wb") as f:
            f.write(blob)
        return p

    img = _smooth(64, 224, seed=3)
    img14 = np.minimum(_smooth(24, 198).astype(np.int64),
                       16368).astype(np.uint16)
    cases = {
        put("a.rw2", make_rw2(img)): "rw2-classic",
        put("b.rw2", make_rw2(img14, payload=encode_panasonic_v6(
            img14, snap=True)[0], bits=14, rawformat=6)): "rw2-v6",
        put("c.rw2", make_rw2(img14, payload=encode_panasonic_v5(img14),
                              bits=14, rawformat=5)): "rw2-v5",
        put("d.rw2", make_rw2(img14, payload=encode_panasonic_v7(img14),
                              bits=14, rawformat=7)): "rw2-v7",
        put("a.nef", make_nef_34713(_rng(4).integers(
            0, 1 << 14, (48, 64)).astype(np.uint16))): "nef-34713-lossless",
        put("x.raf", make_raf(_sensor(36, 48))): "raf-classic-xtrans",
        put("s.raf", make_raf(_sensor(16, 24), pattern=None, extra_recs=[
            (0x0130, bytes([0, 0])),
            (0x0121, struct.pack(">HH", 16, 24))])): "raf-superccd",
        put("t.raf", make_raf_tiff(_sensor(24, 24, seed=7))): "raf-tiff-16bit",
        put("junk.xyz", b"garbage"): "unknown",
        put("c.cr3", b"\x00\x00\x00\x18ftypcrx " + b"\0" * 64):
            "cr3-crx-unsupported",
        put("c.crw", b"II\x1a\x00\x00\x00HEAPCCDR" + b"\0" * 64):
            "crw-ciff-unsupported",
        put("c.x3f", b"FOVb" + b"\0" * 64): "unknown",  # unparseable FOVb
    }
    from imagepipe_tpu.x3f import encode_x3f
    x3f_img = np.stack([(_smooth(8, 12, seed=s) % 900).astype(np.uint16)
                        for s in range(3)], axis=-1)
    cases[put("s.x3f", encode_x3f(x3f_img))] = "x3f-huffman"
    cases[put("m.x3f", encode_x3f(x3f_img, raw_format=30))] = \
        "x3f-fmt30-unsupported"
    img12 = (_smooth(8, 28) % 3000 + 600).astype(np.uint16)
    from imagepipe_tpu.rw2 import encode_panasonic_v6 as _enc6
    cases[put("e.rw2", make_rw2(img12, payload=_enc6(
        img12, snap=True, bits=12)[0], bits=12,
        rawformat=6))] = "rw2-v6-12bit"
    from test_iiq import make_iiq
    cases[put("p.iiq", make_iiq(_smooth(16, 24, seed=5)))] = "iiq-fmt3"
    cases[put("u.iiq", make_iiq(_smooth(8, 12, seed=6),
                                fmt=1))] = "iiq-uncompressed"
    from imagepipe_tpu.sony_srf import _MODELS, encode_srf
    g = _MODELS["DSC-F828"]
    cases[put("f.srf", encode_srf(np.zeros(
        (g["raw_height"], g["raw_width"]), np.uint16), g))] = "srf"
    for path, want in cases.items():
        assert codec_family(path) == want, (path, codec_family(path), want)


def test_realfile_harness_selfcheck(tmp_path):
    """Drive the opt-in real-file harness end-to-end with synthesized
    containers + hand-built sidecars: the per-file assertions run and the
    coverage summary is written, so the first REAL-file run is a known-
    working one-command audit."""
    import subprocess
    import sys

    import numpy as np

    from test_rw2 import make_rw2, _smooth

    img = _smooth(64, 224, seed=11)
    rawp = tmp_path / "shot.rw2"
    rawp.write_bytes(make_rw2(img))
    np.savez(str(rawp) + ".sidecar.npz", raw_image=img,
             black=143, white=4095,
             cam_mul=np.array([470.0, 256.0, 380.0, 0.0]),
             flip=0)
    env = dict(__import__("os").environ,
               IMAGEPIPE_REALFILE_DIR=str(tmp_path),
               JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/test_realfiles.py", "-q"],
        capture_output=True, text=True, timeout=600, env=env,
        cwd=__import__("os").path.dirname(
            __import__("os").path.dirname(__file__)))
    assert r.returncode == 0, r.stdout[-3000:]
    summary = (tmp_path / "coverage_summary.txt").read_text()
    assert "rw2-classic" in summary and "EXERCISED" in summary
    assert "awaiting real bytes" in summary   # open questions listed


# ---------------------------------------------------------------- LinearRaw


def test_dng_linear_roundtrip_all_compressions(tmp_path):
    """SamplesPerPixel=3 (LinearRaw/demosaiced) DNGs: the Lightroom
    'linear DNG' / HDR-merge shape, reached via rawloader in the
    reference (pipeline.rs:264). Uncompressed, Deflate (predictor 1 and
    the per-CHANNEL horizontal predictor 2), and 3-component LJ92 all
    round-trip bit-exact through the canonical writer."""
    from imagepipe_tpu.raw import synthetic_linear

    raw = synthetic_linear(96, 64, seed=11, blacklevel=256, whitelevel=60000)
    for comp, pred in ((1, None), (8, None), (8, 1), (7, None)):
        path = str(tmp_path / f"lin_{comp}_{pred}.dng")
        write_dng(path, raw, compression=comp, predictor=pred)
        back = read_dng(path)
        assert back.cpp == 3
        assert not back.cfa.is_valid()
        np.testing.assert_array_equal(np.asarray(back.data),
                                      np.asarray(raw.data))
        assert back.blacklevels[:3] == raw.blacklevels[:3]
        assert back.whitelevels[0] == raw.whitelevels[0]


def test_dng_linear_float_hdr(tmp_path):
    """Float LinearRaw (SampleFormat 3, spp=3): the Adobe HDR-merge DNG
    shape, Deflate with the byte-planar predictor."""
    from imagepipe_tpu.raw import synthetic_linear

    raw = synthetic_linear(48, 32, seed=3, blacklevel=0, whitelevel=1)
    raw.data = (np.asarray(raw.data, np.float32) / 65535.0).reshape(32, 48 * 3)
    path = str(tmp_path / "hdr.dng")
    write_dng(path, raw, compression=8)
    back = read_dng(path)
    assert back.cpp == 3
    np.testing.assert_allclose(np.asarray(back.data), np.asarray(raw.data))


def test_dng_linear_through_pipeline(tmp_path):
    """LinearRaw decodes to cpp=3 and develops through the engine's rgb
    mode (no demosaic), matching the direct-source develop; codec_family
    labels the variant."""
    from imagepipe_tpu import ImageSource, Pipeline, simple_decode_8bit
    from imagepipe_tpu.decode import codec_family
    from imagepipe_tpu.raw import synthetic_linear

    raw = synthetic_linear(96, 64, seed=6)
    path = str(tmp_path / "lin.dng")
    write_dng(path, raw)
    assert codec_family(path) == "dng-uncompressed-linear"
    out = simple_decode_8bit(path)
    assert (out.width, out.height) == (96, 64)
    direct = Pipeline.new_from_source(
        ImageSource.from_raw(raw)).output_8bit(None)
    # wb rationals quantize to 1e-4 in the container.
    assert np.abs(out.data.astype(int) - direct.data.astype(int)).max() <= 1


def test_dng_linear_rejects_invalid_shapes(tmp_path):
    """spp=2 refused by name; CFA photometric with spp=3 invalid; a
    spatial BlackLevelRepeatDim on LinearRaw refused."""
    from imagepipe_tpu.raw import synthetic_linear

    raw = synthetic_linear(24, 16, seed=1)
    path = str(tmp_path / "lin.dng")
    write_dng(path, raw)
    with open(path, "rb") as f:
        buf = bytearray(f.read())

    def patch(tag, short_value, blob=buf):
        # Locate the IFD entry by scanning (little-endian, 12-byte
        # entries after the 2-byte count at offset 8 — the writer puts
        # IFD0 right after the header).
        n = struct.unpack_from("<H", blob, 8)[0]
        for i in range(n):
            eo = 10 + 12 * i
            if struct.unpack_from("<H", blob, eo)[0] == tag:
                struct.pack_into("<H", blob, eo + 8, short_value)
                return
        raise AssertionError(f"tag {tag} not found")

    bad = bytearray(buf)
    patch(277, 2, bad)           # SamplesPerPixel = 2
    p2 = str(tmp_path / "spp2.dng")
    with open(p2, "wb") as f:
        f.write(bad)
    with pytest.raises(ValueError, match="samples/pixel"):
        read_dng(p2)

    bad = bytearray(buf)
    patch(262, 32803, bad)       # CFA photometric on spp=3
    p3 = str(tmp_path / "cfa3.dng")
    with open(p3, "wb") as f:
        f.write(bad)
    with pytest.raises(ValueError, match="invalid"):
        read_dng(p3)


def test_dng_linear_tiled_lj92(tmp_path):
    """Tiled 3-component LJ92 LinearRaw — the layout Adobe tools write
    for compressed linear DNGs (tiles + lossless JPEG). Hand-assembled
    (the writer emits strips); checks tile reassembly at spp=3 and the
    ragged right/bottom tile crop."""
    from imagepipe_tpu import lj92
    from imagepipe_tpu.decode import codec_family
    from tiffgen import TiffBuilder

    h, w, tl, tw = 20, 24, 12, 16  # 2x2 tiles, padded on both axes
    rng = np.random.default_rng(33)
    img = rng.integers(0, 65535, (h, w, 3), np.uint16)

    tiles = []
    for ty in range(2):
        for tx in range(2):
            tile = np.zeros((tl, tw, 3), np.uint16)
            ys, xs = ty * tl, tx * tw
            sub = img[ys:min(h, ys + tl), xs:min(w, xs + tw)]
            tile[:sub.shape[0], :sub.shape[1]] = sub
            tiles.append(lj92.encode(tile.reshape(tl, tw * 3),
                                     ncomp=3, precision=16))

    b = TiffBuilder("<")
    offs = [b.add_blob(t) for t in tiles]
    b.add_ifd([
        (256, 4, [w]), (257, 4, [h]), (258, 3, [16, 16, 16]),
        (259, 3, [7]), (262, 3, [34892]), (277, 3, [3]),
        (322, 4, [tw]), (323, 4, [tl]),
        (324, 4, offs), (325, 4, [len(t) for t in tiles]),
        (50714, 3, [128, 130, 132]),           # per-channel BlackLevel
        (50717, 4, [65535]),
    ])
    path = str(tmp_path / "lin_tiled.dng")
    with open(path, "wb") as f:
        f.write(b.bytes())

    back = read_dng(path)
    assert back.cpp == 3
    np.testing.assert_array_equal(
        np.asarray(back.data).reshape(h, w, 3), img)
    assert back.blacklevels == (128, 130, 132, 0)
    assert codec_family(path) == "dng-lj92-linear"


def test_dng_lossy_jpeg_reader_pins_pil(tmp_path):
    """DNG 1.4 lossy JPEG (compression 34892, the Lightroom 'lossy DNG'
    shape — rawloader hands the payload to a stock baseline-JPEG codec,
    reference pipeline.rs:264): read_dng's output must equal PIL's own
    decode of the embedded JFIF stream exactly (the codec IS PIL; the
    container route is what this framework adds), and the end-to-end
    error vs the pre-compression data stays small on smooth content."""
    from io import BytesIO

    from PIL import Image

    from imagepipe_tpu.decode import codec_family
    from imagepipe_tpu.raw import synthetic_linear
    from imagepipe_tpu.tiff import TiffFile

    raw = synthetic_linear(96, 64, seed=7, blacklevel=0, whitelevel=255)
    raw.data = (np.asarray(raw.data) & 0xFF).astype(np.uint16)
    path = str(tmp_path / "lossy.dng")
    write_dng(path, raw, compression=34892, quality=95)
    assert codec_family(path) == "dng-lossy-jpeg-linear"

    back = read_dng(path)
    assert back.cpp == 3 and back.whitelevels[0] == 255

    with open(path, "rb") as f:
        buf = f.read()
    tf = TiffFile(buf)
    ifd = [e for e in tf.ifds if e.get(273)][0]
    off, cnt = ifd.get(273)[0], ifd.get(279)[0]
    pil = np.asarray(Image.open(BytesIO(buf[off:off + cnt])))
    np.testing.assert_array_equal(
        np.asarray(back.data).reshape(64, 96, 3), pil)

    orig = np.asarray(raw.data).reshape(64, 96, 3).astype(int)
    assert np.abs(pil.astype(int) - orig).mean() < 4.0


def test_dng_lossy_jpeg_gray_and_pipeline(tmp_path):
    """spp=1 gray lossy DNG round-trips through PIL's L mode; the spp=3
    form develops end-to-end (LinearRaw cpp=3 path)."""
    from imagepipe_tpu import simple_decode_8bit
    from imagepipe_tpu.raw import CFA, Orientation, RawImage, synthetic_linear

    h, w = 32, 48
    rng = np.random.default_rng(5)
    smooth = (np.linspace(16, 240, w)[None, :]
              + rng.integers(0, 4, (h, w))).astype(np.uint16)
    gray = RawImage(width=w, height=h, cpp=1, crops=(0, 0, 0, 0),
                    blacklevels=(0,) * 4, whitelevels=(255,) * 4,
                    wb_coeffs=(float("nan"),) * 4,
                    xyz_to_cam=np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1],
                                         [0, 0, 0]], np.float32),
                    orientation=Orientation.Normal, cfa=CFA(""), data=smooth)
    pg = str(tmp_path / "gray.dng")
    write_dng(pg, gray, compression=34892, quality=92)
    back = read_dng(pg)
    assert back.cpp == 1 and not back.cfa.is_valid()
    assert np.abs(np.asarray(back.data).astype(int)
                  - smooth.astype(int)).mean() < 4.0

    raw = synthetic_linear(96, 64, seed=9, blacklevel=0, whitelevel=255)
    raw.data = (np.asarray(raw.data) & 0xFF).astype(np.uint16)
    p3 = str(tmp_path / "lossy3.dng")
    write_dng(p3, raw, compression=34892)
    out = simple_decode_8bit(p3)
    assert (out.width, out.height) == (96, 64)


def test_dng_lossy_jpeg_tiled(tmp_path):
    """Tiled lossy DNG (the layout Adobe writes): per-tile JFIF streams
    reassemble with ragged right/bottom crop; a tile whose JPEG dims
    disagree with the tile grid fails loud."""
    from io import BytesIO

    from PIL import Image

    from tiffgen import TiffBuilder

    h, w, tl, tw = 20, 24, 12, 16
    rng = np.random.default_rng(44)
    img = np.clip(np.linspace(0, 255, w)[None, :, None]
                  + rng.integers(0, 6, (h, w, 3)), 0, 255).astype(np.uint8)

    def jfif(tile):
        bio = BytesIO()
        Image.fromarray(tile, "RGB").save(bio, "JPEG", quality=95,
                                          subsampling=0)
        return bio.getvalue()

    tiles, decoded = [], []
    for ty in range(2):
        for tx in range(2):
            tile = np.zeros((tl, tw, 3), np.uint8)
            ys, xs = ty * tl, tx * tw
            sub = img[ys:min(h, ys + tl), xs:min(w, xs + tw)]
            tile[:sub.shape[0], :sub.shape[1]] = sub
            blob = jfif(tile)
            tiles.append(blob)
            decoded.append(np.asarray(Image.open(BytesIO(blob))))

    def build(tile_blobs):
        b = TiffBuilder("<")
        offs = [b.add_blob(t) for t in tile_blobs]
        b.add_ifd([
            (256, 4, [w]), (257, 4, [h]), (258, 3, [8, 8, 8]),
            (259, 3, [34892]), (262, 3, [34892]), (277, 3, [3]),
            (322, 4, [tw]), (323, 4, [tl]),
            (324, 4, offs), (325, 4, [len(t) for t in tile_blobs]),
            (50717, 4, [255]),
        ])
        return b.bytes()

    path = str(tmp_path / "lossy_tiled.dng")
    with open(path, "wb") as f:
        f.write(build(tiles))
    back = read_dng(path)
    expect = np.zeros((2 * tl, 2 * tw, 3), np.uint16)
    for ti, dec in enumerate(decoded):
        ty, tx = divmod(ti, 2)
        expect[ty * tl:(ty + 1) * tl, tx * tw:(tx + 1) * tw] = dec
    np.testing.assert_array_equal(
        np.asarray(back.data).reshape(h, w, 3), expect[:h, :w])

    # Wrong-size JPEG in a tile slot: fail loud, never silent-pad.
    bad = tiles[:3] + [jfif(np.zeros((8, 8, 3), np.uint8))]
    pbad = str(tmp_path / "badtile.dng")
    with open(pbad, "wb") as f:
        f.write(build(bad))
    with pytest.raises(ValueError, match="lossy-JPEG"):
        read_dng(pbad)


def test_dng_lossy_jpeg_rejects(tmp_path):
    """Spec guards: CFA photometric with 34892 invalid; truncated/garbage
    JFIF streams raise named ValueErrors; LinearizationTable still maps
    the 8-bit codes (the real Lightroom shape stores a tone LUT)."""
    from imagepipe_tpu.raw import synthetic_linear

    raw = synthetic_linear(48, 32, seed=2, blacklevel=0, whitelevel=255)
    raw.data = (np.asarray(raw.data) & 0xFF).astype(np.uint16)
    path = str(tmp_path / "lossy.dng")
    write_dng(path, raw, compression=34892)
    with open(path, "rb") as f:
        base = bytearray(f.read())

    def patch_short(blob, tag, short_value):
        n = struct.unpack_from("<H", blob, 8)[0]
        for i in range(n):
            eo = 10 + 12 * i
            if struct.unpack_from("<H", blob, eo)[0] == tag:
                struct.pack_into("<H", blob, eo + 8, short_value)
                return
        raise AssertionError(f"tag {tag} not found")

    bad = bytearray(base)
    patch_short(bad, 262, 32803)     # CFA photometric
    p = str(tmp_path / "cfa.dng")
    with open(p, "wb") as f:
        f.write(bad)
    with pytest.raises(ValueError, match="CFA photometric"):
        read_dng(p)

    # Garbage payload: overwrite the strip with noise.
    from imagepipe_tpu.tiff import TiffFile

    tf = TiffFile(bytes(base))
    ifd = [e for e in tf.ifds if e.get(273)][0]
    off, cnt = ifd.get(273)[0], ifd.get(279)[0]
    bad = bytearray(base)
    bad[off:off + cnt] = bytes(cnt)
    p = str(tmp_path / "garbage.dng")
    with open(p, "wb") as f:
        f.write(bad)
    with pytest.raises(ValueError, match="corrupt lossy-JPEG"):
        read_dng(p)

    # Truncation sweep over the JFIF stream: named error, no crash.
    for frac in (0.1, 0.5, 0.9):
        bad = bytearray(base[: off + int(cnt * frac)])
        p = str(tmp_path / f"trunc{frac}.dng")
        with open(p, "wb") as f:
            f.write(bad)
        with pytest.raises(ValueError):
            read_dng(p)


def test_dng_fp24_bitlevel_roundtrip():
    """fp24 <-> f32 conversion: every finite fp24 bit pattern converts to
    f32 and back bit-exactly (the 16-bit mantissa always fits f32, so the
    mapping is injective); specials map to inf/nan; denormals are exact."""
    from imagepipe_tpu.dng import _f32_to_fp24, _fp24_to_f32

    rng = np.random.default_rng(17)
    pats = rng.integers(0, 1 << 24, 20000, np.uint32)
    # Pin the structured corners too: zeros, denormal min/max, normal
    # min/max, +-inf.
    pats = np.concatenate([pats, np.array(
        [0, 0x800000, 1, 0xFFFF, 0x80FFFF, 0x010000, 0x7EFFFF,
         0x7F0000, 0xFF0000], np.uint32)])
    b3 = np.stack([(pats >> 16) & 0xFF, (pats >> 8) & 0xFF,
                   pats & 0xFF], axis=-1).astype(np.uint8)
    f = _fp24_to_f32(b3)
    finite = np.isfinite(f)
    assert np.isinf(f[np.where((pats & 0x7FFFFF) == 0x7F0000)]).all()
    back = _f32_to_fp24(f[finite])
    np.testing.assert_array_equal(back, b3[finite])
    # Denormal spot value: pattern 0x000001 = 2^-78 exactly.
    one = _fp24_to_f32(np.array([[0, 0, 1]], np.uint8))[0]
    assert one == np.float32(2.0 ** -78)
    # Normal spot value: exponent 63, frac 0 -> 1.0.
    assert _fp24_to_f32(np.array([[63, 0, 0]], np.uint8))[0] == 1.0


def test_dng_fp24_payloads(tmp_path):
    """24-bit float DNG (the named former gap): uncompressed, Deflate
    predictor 1, and the byte-planar float predictor 3 all round-trip
    bit-exact for data already on the fp24 grid; fp32 input quantizes by
    mantissa truncation."""
    from imagepipe_tpu.dng import _f32_to_fp24, _fp24_to_f32
    from imagepipe_tpu.raw import synthetic_linear

    raw = synthetic_linear(48, 32, seed=8, blacklevel=0, whitelevel=1)
    f32 = (np.asarray(raw.data, np.float32) / 65535.0).reshape(32, 48 * 3)
    on_grid = _fp24_to_f32(_f32_to_fp24(f32)).reshape(32, 48 * 3)
    raw.data = on_grid
    for comp, pred in ((1, None), (8, 1), (8, None)):
        path = str(tmp_path / f"fp24_{comp}_{pred}.dng")
        write_dng(path, raw, compression=comp, predictor=pred,
                  float_bits=24)
        back = read_dng(path)
        assert np.asarray(back.data).dtype == np.float32
        np.testing.assert_array_equal(np.asarray(back.data), on_grid)
    # Truncation semantics: off-grid fp32 maps to the floor grid point.
    offgrid = on_grid + np.float32(1e-7)
    raw.data = offgrid
    path = str(tmp_path / "fp24_trunc.dng")
    write_dng(path, raw, compression=1, float_bits=24)
    back = np.asarray(read_dng(path).data)
    assert (back <= offgrid).all()
    assert np.abs(back - offgrid).max() <= 2.0 ** -16
