"""Batched production serving: develop a directory of camera RAWs.

Usage: python examples/batch_serve.py <dir-or-files...> [--out outdir]

Decodes concurrently on host threads, buckets by sensor shape, and
develops through the fused XLA engine on a data-parallel device mesh
(decode of batch N+1 overlaps develop of batch N; HBM bounded by the
in-flight window). Writes JPEGs next to the inputs or into --out.
"""

import pathlib
import sys

import numpy as np
from PIL import Image

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from imagepipe_tpu.parallel import BatchEngine  # noqa: E402

RAW_EXTS = (".dng", ".nef", ".nrw", ".cr2", ".arw", ".sr2", ".raf",
            ".tif", ".tiff", ".pgm", ".synraw", ".synraw.npz")


def main(argv):
    out_dir = None
    if "--out" in argv:
        i = argv.index("--out")
        out_dir = pathlib.Path(argv[i + 1])
        out_dir.mkdir(parents=True, exist_ok=True)
        argv = argv[:i] + argv[i + 2:]

    files = []
    for a in argv:
        p = pathlib.Path(a)
        if p.is_dir():
            files += sorted(q for q in p.iterdir()
                            if q.name.lower().endswith(RAW_EXTS))
        else:
            files.append(p)
    if not files:
        print("no inputs", file=sys.stderr)
        return 2

    engine = BatchEngine(max_batch=8)
    # errors='skip': one corrupt file must not discard the directory's work.
    outputs = engine.develop_files([str(p) for p in files], errors="skip")
    written = set()
    for src, img in zip(files, outputs):
        if not isinstance(img, np.ndarray):   # BatchError slot
            print(f"{src}: SKIPPED ({img.error})", file=sys.stderr)
            continue
        dst = (out_dir / src.name if out_dir else src).with_suffix(".jpg")
        n = 1
        while dst in written:          # same-stem inputs must not clobber
            dst = dst.with_name(f"{dst.stem}-{n}.jpg")
            n += 1
        written.add(dst)
        Image.fromarray(img).save(str(dst), quality=90)
        print(f"{src} -> {dst} ({img.shape[1]}x{img.shape[0]})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
