"""NEF compression-34713 codec (imagepipe_tpu/nikon.py + native/nikon.cc).

Round-trips pin the stream mechanics (canonical Huffman assignment,
predictor integration, bit packing); python-vs-native differential decode
(including on random streams) pins the two implementations against each
other across all leaf paths; the container test pins read_nef wiring.
Real-file cross-validation (test_realfiles.py) is the external check on
the table constants themselves."""

import struct

import numpy as np
import pytest

from imagepipe_tpu import native
from imagepipe_tpu.nikon import (NIKON_TREES, _codes, _decode_python,
                                 decode_34713, encode_34713,
                                 parse_linearization)
from tiffgen import TiffBuilder


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("bits", [12, 14])
def test_roundtrip_random(bits):
    data = _rng(1).integers(0, 1 << bits, (32, 48)).astype(np.uint16)
    payload, meta = encode_34713(data, bits=bits)
    out, white = decode_34713(payload, 48, 32, bits, meta)
    np.testing.assert_array_equal(out, data)
    assert white == (1 << bits) - 1


@pytest.mark.parametrize("bits", [12, 14])
def test_roundtrip_gradients_and_flats(bits):
    """Small-delta data exercises the short codes; flats the zero leaf."""
    y, x = np.mgrid[0:16, 0:64]
    data = ((y * 7 + x) % (1 << bits)).astype(np.uint16)
    data[4:8] = 1000
    payload, meta = encode_34713(data, bits=bits)
    out, _ = decode_34713(payload, 64, 16, bits, meta)
    np.testing.assert_array_equal(out, data)


def test_trees_are_prefix_codes():
    for t in range(6):
        codes = _codes(t)
        seen = set()
        for code, length, _ in codes:
            cs = format(code, f"0{length}b")
            for p in seen:
                assert not cs.startswith(p) and not p.startswith(cs)
            seen.add(cs)
        counts, values = NIKON_TREES[t]
        assert sum(counts) >= len(values)


@pytest.mark.skipif(not (native.have_native()
                         and hasattr(native._lib, "nikon_decode")),
                    reason="native library not built")
def test_python_native_equivalence():
    from imagepipe_tpu.nikon import _decode_native

    bits = 14
    data = _rng(2).integers(0, 1 << bits, (24, 40)).astype(np.uint16)
    payload, meta = encode_34713(data, bits=bits)
    tree, vpred, curve, split, _ = parse_linearization(meta, bits)
    py = _decode_python(payload, 40, 24, tree, vpred, curve, split)
    nat = _decode_native(payload, 40, 24, tree, vpred, curve, split)
    np.testing.assert_array_equal(py, nat)


@pytest.mark.skipif(not (native.have_native()
                         and hasattr(native._lib, "nikon_decode")),
                    reason="native library not built")
@pytest.mark.parametrize("tree", [0, 1, 3, 4])
def test_python_native_differential_fuzz(tree):
    """Random bitstreams through BOTH decoders (the lossy trees' shl leaves
    have no encoder): outputs must match exactly, or both must reject."""
    from imagepipe_tpu.nikon import _decode_native

    curve = np.arange(0x10000, dtype=np.uint16)
    vpred = np.array([[2048, 2048], [2048, 2048]], np.int32)
    for seed in range(6):
        payload = _rng(100 + seed).integers(0, 256, 600).astype(np.uint8)
        payload = payload.tobytes()
        try:
            py = _decode_python(payload, 16, 8, tree, vpred, curve, 0)
        except ValueError:
            py = None
        try:
            nat = _decode_native(payload, 16, 8, tree, vpred, curve, 0)
        except ValueError:
            nat = None
        if py is None or nat is None:
            assert py is None and nat is None, (tree, seed)
        else:
            np.testing.assert_array_equal(py, nat)


def test_lossy_curve_parse_and_split():
    """ver 0x44/0x20: sampled curve linearly interpolated (dcraw's fill
    loop), split row read from blob offset 562."""
    bits = 12
    vmax = 1 << bits
    csize = 17
    step = vmax // (csize - 1)
    samples = (np.arange(csize, dtype=np.int64) ** 2 * 15).astype(np.uint16)
    meta = bytearray()
    meta += bytes([0x44, 0x20])
    meta += struct.pack(">4H", 300, 300, 300, 300)
    meta += struct.pack(">H", csize)
    meta += b"".join(struct.pack(">H", int(s)) for s in samples)
    meta += b"\0" * (562 - len(meta))
    meta += struct.pack(">H", 5)        # split row
    tree, vpred, curve, split, white = parse_linearization(bytes(meta), bits)
    assert tree == 0 and split == 5
    assert (vpred == 300).all()
    np.testing.assert_array_equal(curve[np.arange(csize) * step], samples)
    # Interpolation between two known samples.
    lo, hi = int(samples[3]), int(samples[4])
    i = 3 * step + step // 2
    assert curve[i] == (lo * (step - step // 2) + hi * (step // 2)) // step
    # White is the (interpolated) top of the in-range curve, curve[vmax-1].
    assert white == int(curve[vmax - 1])
    assert int(samples[-2]) < white <= int(samples[-1])


def test_lossy_type2_curve_parse():
    """ver 0x44/0x40 ("lossy type 2"): identical sampled-curve handling
    but sample spacing AND curve domain quartered (dcraw's step/=4,
    max/=4); split still at blob offset 562."""
    from imagepipe_tpu.nikon import encode_34713_lossy2

    bits = 14
    samples = np.linspace(0, (1 << bits) - 1, 257).astype(np.uint16)
    _, meta = encode_34713_lossy2(np.zeros((2, 4), np.uint16), bits,
                                  samples=samples, split=7)
    tree, vpred, curve, split, white = parse_linearization(meta, bits)
    assert tree == 3 and split == 7
    step = (1 << bits) // 256 // 4            # quartered spacing
    vmax4 = (1 << bits) // 4                  # quartered domain
    np.testing.assert_array_equal(curve[np.arange(257) * step], samples)
    assert white == int(curve[vmax4 - 1])
    # Degenerate type 2 (step would quarter to zero) still refuses.
    bad = bytearray(meta)
    struct.pack_into(">H", bad, 10, 0x4001)   # csize too large
    with pytest.raises(ValueError, match="unrecognized linearization"):
        parse_linearization(bytes(bad), bits)


@pytest.mark.parametrize("split", [0, 5])
def test_lossy_type2_roundtrip(split):
    """Canonical type-2 streams decode to curve[pred] through both the
    lossy tree and (split>0) the after-split tree."""
    from imagepipe_tpu.nikon import encode_34713_lossy2

    bits = 14
    rng = _rng(11)
    # Quarter-range predictor plane with moderate steps (the after-split
    # tree's plain leaves cover ssss <= 8, so keep diffs under 255).
    base = 2048 + np.cumsum(rng.integers(-100, 101, (12, 20)), axis=1)
    pred = np.clip(base, 0, 4095).astype(np.uint16)
    payload, meta = encode_34713_lossy2(pred, bits, split=split)
    tree, vpred, curve, got_split, white = parse_linearization(meta, bits)
    assert got_split == split
    out, got_white = decode_34713(payload, 20, 12, bits, meta)
    np.testing.assert_array_equal(out, curve[pred])
    assert got_white == white
    if native.have_native() and hasattr(native._lib, "nikon_decode"):
        from imagepipe_tpu.nikon import _decode_native

        py = _decode_python(payload, 20, 12, tree, vpred, curve, split)
        nat = _decode_native(payload, 20, 12, tree, vpred, curve, split)
        np.testing.assert_array_equal(py, nat)


def test_corrupt_payload_rejected():
    data = _rng(3).integers(0, 1 << 14, (8, 16)).astype(np.uint16)
    payload, meta = encode_34713(data, bits=14)
    with pytest.raises(ValueError):
        decode_34713(payload[: len(payload) // 3], 16, 8, 14, meta)
    with pytest.raises(ValueError):
        parse_linearization(b"\x46", 14)


def make_nef_34713(data, bits=14, model="NIKON D850", wb_r=2.0, wb_b=1.5,
                   black=150, payload=None, meta=None) -> bytes:
    """A compressed NEF container around an encode_34713 stream (mirrors
    tests/test_vendor.py make_nef). Pass payload+meta to wrap a stream
    from another encoder (e.g. lossy type 2)."""
    h, w = data.shape
    if payload is None:
        payload, meta = encode_34713(data, bits=bits)
    b = TiffBuilder(">")
    strip = b.add_blob(payload)
    raw_ifd = b.add_ifd([
        (256, 4, [w]), (257, 4, [h]), (258, 3, [bits]), (259, 3, [34713]),
        (262, 3, [32803]),
        (273, 4, [strip]), (278, 4, [h]), (279, 4, [len(payload)]),
        (33421, 3, [2, 2]), (33422, 1, [0, 1, 1, 2]),
    ], chain=False)
    note = TiffBuilder("<")
    note.add_ifd([
        (0x000C, 5, [(int(wb_r * 10000), 10000), (int(wb_b * 10000), 10000),
                     (10000, 10000), (10000, 10000)]),
        (0x003D, 3, [black] * 4),
        (0x0096, 7, meta),
    ])
    note_blob = b"Nikon\0" + b"\x02\x11\x00\x00" + note.bytes()
    exif_ifd = b.add_ifd([(37500, 7, note_blob)], chain=False)
    b.add_ifd([
        (271, 2, "NIKON CORPORATION"), (272, 2, model), (274, 3, [1]),
        (330, 4, [raw_ifd]), (34665, 4, [exif_ifd]),
    ])
    return b.bytes()


def test_nef_34713_container_decode(tmp_path):
    from imagepipe_tpu.decode import decode_file

    data = _rng(4).integers(0, 1 << 14, (48, 64)).astype(np.uint16)
    path = str(tmp_path / "comp.nef")
    with open(path, "wb") as f:
        f.write(make_nef_34713(data))
    raw = decode_file(path).raw
    np.testing.assert_array_equal(raw.data, data)
    assert raw.whitelevels[0] == (1 << 14) - 1
    assert raw.blacklevels == (150,) * 4
    assert raw.cfa.name == "RGGB"
    assert raw.wb_coeffs[:3] == (pytest.approx(2.0), pytest.approx(1.0),
                                 pytest.approx(1.5))


def test_camera_registry_aliases_and_dng_growth(tmp_path):
    """Registry growth paths: sensor-family aliases resolve to the base
    entry, and register_from_dng pulls ColorMatrix1 from a user's DNG
    (verifiable provenance, the documented way to add unlisted bodies)."""
    import numpy as np

    from imagepipe_tpu.cameras import (known_cameras, register_from_dng,
                                       xyz_to_cam_for)
    from imagepipe_tpu.dng import write_dng
    from imagepipe_tpu.raw import RawImage, CFA, Orientation

    # Alias: X-T3 (X-Trans IV family) resolves to the X-T30 matrix.
    np.testing.assert_array_equal(xyz_to_cam_for("FUJIFILM", "X-T3"),
                                  xyz_to_cam_for("FUJIFILM", "X-T30"))
    assert "X-T3" in known_cameras()

    # DNG growth: write a DNG with a known matrix, register, look up.
    m = np.array([[0.9, -0.2, -0.1], [-0.4, 1.2, 0.2], [-0.1, 0.2, 0.6],
                  [0, 0, 0]], np.float32)
    raw = RawImage(width=16, height=8, cpp=1, crops=(0, 0, 0, 0),
                   blacklevels=(0,) * 4, whitelevels=(16383,) * 4,
                   wb_coeffs=(2.0, 1.0, 1.5, float("nan")), xyz_to_cam=m,
                   orientation=Orientation.Normal, cfa=CFA("RGGB"),
                   data=np.zeros((8, 16), np.uint16),
                   make="ACME", model="ACME X100")
    path = str(tmp_path / "probe.dng")
    write_dng(path, raw)
    key = register_from_dng(path)
    assert key == "ACME X100"
    got = xyz_to_cam_for("ACME", "ACME X100")
    np.testing.assert_allclose(got[:3], m[:3], atol=1e-4)


def test_camera_registry_sidecar_dir_and_warning_recipe(tmp_path, caplog,
                                                        monkeypatch):
    """Fleet-boot registry growth: register_sidecar_dir batch-loads every
    sidecar DNG (skipping corrupt ones), IMAGEPIPE_SIDECAR_DIR auto-loads
    on first lookup, and the unknown-body warning prints the exact
    one-command recipe (VERDICT r4 item 6: calibrated color or an
    actionable warning, never a silent fallback)."""
    import logging

    import numpy as np

    from imagepipe_tpu import cameras
    from imagepipe_tpu.dng import write_dng
    from imagepipe_tpu.raw import RawImage, CFA, Orientation

    def probe_dng(path, model, scale):
        m = np.array([[0.9, -0.2, -0.1], [-0.4, 1.2, 0.2],
                      [-0.1, 0.2, 0.6], [0, 0, 0]], np.float32) * scale
        raw = RawImage(width=16, height=8, cpp=1, crops=(0, 0, 0, 0),
                       blacklevels=(0,) * 4, whitelevels=(16383,) * 4,
                       wb_coeffs=(2.0, 1.0, 1.5, float("nan")),
                       xyz_to_cam=m, orientation=Orientation.Normal,
                       cfa=CFA("RGGB"), data=np.zeros((8, 16), np.uint16),
                       make="ACME", model=model)
        write_dng(str(path), raw)
        return m

    side = tmp_path / "sidecars"
    side.mkdir()
    m1 = probe_dng(side / "a.dng", "ACME FLEET1", 1.0)
    probe_dng(side / "b.dng", "ACME FLEET2", 0.9)
    (side / "corrupt.dng").write_bytes(b"not a dng at all")
    (side / "ignored.txt").write_bytes(b"x")

    keys = cameras.register_sidecar_dir(str(side))
    assert keys == ["ACME FLEET1", "ACME FLEET2"]
    np.testing.assert_allclose(
        cameras.xyz_to_cam_for("ACME", "ACME FLEET1")[:3], m1[:3], atol=1e-4)

    # Env auto-load: fresh guard, env set -> first lookup registers.
    side2 = tmp_path / "sidecars2"
    side2.mkdir()
    m3 = probe_dng(side2 / "c.dng", "ACME FLEET3", 1.1)
    monkeypatch.setattr(cameras, "_sidecar_loaded", False)
    monkeypatch.setenv(cameras._SIDECAR_ENV, str(side2))
    np.testing.assert_allclose(
        cameras.xyz_to_cam_for("ACME", "ACME FLEET3")[:3], m3[:3], atol=1e-4)

    # Unknown body: warning carries the exact recipe + the env knob.
    with caplog.at_level(logging.WARNING, logger="imagepipe_tpu.cameras"):
        out = cameras.xyz_to_cam_for("ACME", "ACME UNKNOWN99")
    np.testing.assert_array_equal(out[:3], np.eye(3, dtype=np.float32))
    text = "\n".join(r.getMessage() for r in caplog.records)
    assert "register_from_dng" in text and cameras._SIDECAR_ENV in text


def test_nef_34713_multi_strip_concatenates(tmp_path):
    """A compressed payload split across strips is one logical bitstream."""
    from imagepipe_tpu.decode import decode_file

    data = _rng(6).integers(0, 1 << 14, (32, 48)).astype(np.uint16)
    payload, meta = encode_34713(data, bits=14)
    cut = (len(payload) // 2) & ~1
    b = TiffBuilder(">")
    s1 = b.add_blob(payload[:cut])
    s2 = b.add_blob(payload[cut:])
    raw_ifd = b.add_ifd([
        (256, 4, [48]), (257, 4, [32]), (258, 3, [14]), (259, 3, [34713]),
        (262, 3, [32803]),
        (273, 4, [s1, s2]), (279, 4, [cut, len(payload) - cut]),
        (33421, 3, [2, 2]), (33422, 1, [0, 1, 1, 2]),
    ], chain=False)
    note = TiffBuilder("<")
    note.add_ifd([(0x0096, 7, meta)])
    note_blob = b"Nikon\0" + b"\x02\x11\x00\x00" + note.bytes()
    exif_ifd = b.add_ifd([(37500, 7, note_blob)], chain=False)
    b.add_ifd([(271, 2, "NIKON CORPORATION"), (272, 2, "NIKON D850"),
               (274, 3, [1]), (330, 4, [raw_ifd]), (34665, 4, [exif_ifd])])
    path = str(tmp_path / "multistrip.nef")
    with open(path, "wb") as f:
        f.write(b.bytes())
    raw = decode_file(path).raw
    np.testing.assert_array_equal(raw.data, data)


def test_nef_34713_missing_meta_rejected(tmp_path):
    data = _rng(5).integers(0, 1 << 14, (8, 16)).astype(np.uint16)
    payload, _ = encode_34713(data, bits=14)
    b = TiffBuilder(">")
    strip = b.add_blob(payload)
    raw_ifd = b.add_ifd([
        (256, 4, [16]), (257, 4, [8]), (258, 3, [14]), (259, 3, [34713]),
        (262, 3, [32803]), (273, 4, [strip]), (279, 4, [len(payload)]),
        (33421, 3, [2, 2]), (33422, 1, [0, 1, 1, 2]),
    ], chain=False)
    b.add_ifd([(271, 2, "NIKON CORPORATION"), (272, 2, "NIKON D850"),
               (330, 4, [raw_ifd])])
    path = str(tmp_path / "nometa.nef")
    with open(path, "wb") as f:
        f.write(b.bytes())
    from imagepipe_tpu.vendor import read_nef

    with pytest.raises(ValueError, match="0x0096|linearization"):
        read_nef(path)


def test_nef_lossy_type2_container_decode(tmp_path):
    from imagepipe_tpu.decode import decode_file
    from imagepipe_tpu.nikon import encode_34713_lossy2

    bits = 14
    rng = _rng(12)
    base = 1500 + np.cumsum(rng.integers(-80, 81, (24, 32)), axis=1)
    pred = np.clip(base, 0, 4095).astype(np.uint16)
    payload, meta = encode_34713_lossy2(pred, bits)
    _, _, curve, _, white = parse_linearization(meta, bits)
    path = str(tmp_path / "lossy2.nef")
    with open(path, "wb") as f:
        f.write(make_nef_34713(pred, bits=bits, payload=payload, meta=meta))
    raw = decode_file(path).raw
    np.testing.assert_array_equal(raw.data, curve[pred])
    assert raw.whitelevels[0] == white
