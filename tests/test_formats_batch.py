"""Cross-format batch integration: one develop_files call over a mixed
directory of vendor containers (the production serving shape).

Each file's batched output must equal its single-image Pipeline develop
(shape bucketing groups by sensor geometry + plan statics, so formats
mix freely in one call)."""

import numpy as np

from imagepipe_tpu.parallel import BatchEngine
from imagepipe_tpu.pipeline import Pipeline


def _mixed_dir(tmp_path):
    """A directory of five formats (three distinct sensor shapes)."""
    import sys

    sys.path.insert(0, str(tmp_path.parent))
    from test_mrw import make_mrw
    from test_pentax import _mn_entries
    from test_rw2 import _smooth as rw2_smooth
    from test_rw2 import make_rw2
    from test_vendor import _sensor, make_orf, make_pef
    from imagepipe_tpu.olympus import encode_olympus
    from imagepipe_tpu.pentax import PentaxHuff, encode_pentax
    from imagepipe_tpu.vendor import register_orf_pattern

    paths = []

    register_orf_pattern("E-M1MarkII", "RGGB")
    yy, xx = np.mgrid[0:32, 0:48]
    rng = np.random.default_rng(1)
    odata = (700 + yy * 9 + xx * 5
             + rng.integers(0, 24, (32, 48))).astype(np.uint16)
    p = tmp_path / "a.orf"
    p.write_bytes(make_orf(odata, model="E-M1MarkII",
                           payload=encode_olympus(odata),
                           wb=(2.0, 1.0, 1.5, float("nan"))))
    paths.append(str(p))

    huff = PentaxHuff.uniform(15)
    pdata = _sensor(32, 48, seed=2, bits=12)
    p = tmp_path / "b.pef"
    p.write_bytes(make_pef(pdata, bits=12, compression=65535,
                           payload=encode_pentax(pdata, huff),
                           makernote=_mn_entries(huff, ">"),
                           mn_style="AOC"))
    paths.append(str(p))

    rdata = rw2_smooth(64, 224, seed=3)
    p = tmp_path / "c.rw2"
    p.write_bytes(make_rw2(rdata))
    paths.append(str(p))

    mdata = _sensor(32, 48, seed=4, bits=12)
    p = tmp_path / "d.mrw"
    p.write_bytes(make_mrw(mdata))
    paths.append(str(p))

    ndata = _sensor(24, 64, seed=5, bits=12)
    from test_vendor import make_nef

    p = tmp_path / "e.nef"
    p.write_bytes(make_nef(ndata))
    paths.append(str(p))
    return paths


def test_mixed_format_directory_batches(tmp_path):
    paths = _mixed_dir(tmp_path)
    outs = BatchEngine(max_batch=4).develop_files(paths, errors="skip")
    assert len(outs) == len(paths)
    for path, got in zip(paths, outs):
        assert not isinstance(got, Exception), (path, got)
        want = Pipeline.new_from_file(path).output_8bit().data
        # Batched dispatch and the single-image pipeline may take
        # different executors (megakernel vs fused XLA) whose fusion
        # boundaries move FMA placement: the cross-path contract is
        # <= 1 LSB with a small flip fraction, same as the sharded and
        # fused-vs-staged comparisons.
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1, (path, diff.max())
        assert (diff > 0).mean() < 0.05, (path, (diff > 0).mean())
