#!/usr/bin/env python3
"""Build native/ (cmake + ninja) WITHOUT importing the package.

`python -m imagepipe_tpu.native --build` imports imagepipe_tpu and
therefore jax. This script imports neither: it builds on a machine
with no accelerator and no JAX installed.

Usage: python scripts/build_native.py [--clean]
"""

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "native")
BUILD = os.path.join(SRC, "build")


def main() -> int:
    if "--clean" in sys.argv and os.path.isdir(BUILD):
        shutil.rmtree(BUILD)
    os.makedirs(BUILD, exist_ok=True)
    gen = ["-G", "Ninja"] if shutil.which("ninja") else []
    try:
        subprocess.run(["cmake", "-S", SRC, "-B", BUILD, *gen], check=True)
        subprocess.run(["cmake", "--build", BUILD], check=True)
    except subprocess.CalledProcessError as e:
        print(f"native build failed: {e}", file=sys.stderr)
        return 1
    lib = os.path.join(BUILD, "libimagepipe_host.so")
    print("built:", lib if os.path.exists(lib) else "MISSING libimagepipe_host.so")
    return 0 if os.path.exists(lib) else 1


if __name__ == "__main__":
    sys.exit(main())
