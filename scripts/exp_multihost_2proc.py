"""REAL two-process validation of the multi-host input feed.

Spawns two OS processes that form a jax.distributed fleet on localhost
(CPU backend, 4 virtual devices each -> an 8-device global mesh) and run
MultiHostBatchEngine.develop_files over a shared directory; the parent
checks both hosts' partitions against a single-process BatchEngine
develop of the same files. This exercises the non-degenerate paths the
in-suite tests cannot: jax.make_array_from_process_local_data over
actually-non-addressable shards, process_allgather agreement, and the
per-host addressable-shard fetch.

Run: python scripts/exp_multihost_2proc.py
"""

import os
import subprocess
import sys
import tempfile

import numpy as np

_WORKER = r"""
import os, pickle, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1]); port = sys.argv[2]; workdir = sys.argv[3]
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())
sys.path.insert(0, os.getcwd())
from imagepipe_tpu.parallel.multihost import (MultiHostBatchEngine,
                                              partition_files)
paths = sorted(os.path.join(workdir, f) for f in os.listdir(workdir)
               if f.endswith(".synraw.npz"))
eng = MultiHostBatchEngine()
outs = eng.develop_files(paths)
mine = partition_files(paths)
with open(os.path.join(workdir, f"out_{pid}.pkl"), "wb") as f:
    pickle.dump({p: o for p, o in zip(mine, outs)}, f)
print(f"worker {pid}: {len(outs)} results, local_dp={eng.local_dp}",
      flush=True)
"""


def main():
    env_base = {**os.environ, "JAX_PLATFORMS": "cpu"}
    with tempfile.TemporaryDirectory() as td:
        # Make the input files (single-process, plain CPU).
        mk = subprocess.run(
            [sys.executable, "-c", f"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax; jax.config.update("jax_platforms", "cpu")
import sys; sys.path.insert(0, os.getcwd())
from imagepipe_tpu.decode import save_synraw
from imagepipe_tpu.raw import synthetic_bayer
for s in range(11):
    save_synraw(os.path.join({td!r}, f"f{{s:02d}}.synraw.npz"),
                synthetic_bayer(96, 64, seed=100 + s))
# A second sensor shape, interleaved by name: the round-robin partition
# gives both hosts a mixed-bucket schedule.
for s in range(3):
    save_synraw(os.path.join({td!r}, f"f{{s:02d}}x.synraw.npz"),
                synthetic_bayer(48, 32, seed=200 + s))
# And ONE file of a third shape: exactly one host owns its bucket, so
# the other must fabricate padding rows from the broadcast metadata.
save_synraw(os.path.join({td!r}, "g_lonely.synraw.npz"),
            synthetic_bayer(144, 96, seed=300))
print("made 15 files (3 shape buckets)")
"""], env=env_base, capture_output=True, text=True, timeout=600)
        print(mk.stdout.strip(), mk.stderr.strip()[-300:] or "")
        assert mk.returncode == 0

        port = "29517"
        workers = [
            subprocess.Popen(
                [sys.executable, "-c", _WORKER, str(pid), port, td],
                env=env_base, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
            for pid in range(2)
        ]
        logs = []
        for w in workers:
            out, _ = w.communicate(timeout=900)
            logs.append(out)
        for pid, (w, log) in enumerate(zip(workers, logs)):
            print(f"--- worker {pid} (rc {w.returncode}) ---")
            print("\n".join(log.strip().splitlines()[-4:]))
            assert w.returncode == 0, f"worker {pid} failed"

        # Reference: single-process BatchEngine over the same files.
        ref = subprocess.run(
            [sys.executable, "-c", f"""
import os, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax; jax.config.update("jax_platforms", "cpu")
import sys; sys.path.insert(0, os.getcwd())
from imagepipe_tpu.parallel import BatchEngine
paths = sorted(os.path.join({td!r}, f) for f in os.listdir({td!r})
               if f.endswith(".synraw.npz"))
outs = BatchEngine(max_batch=8).develop_files(paths)
with open(os.path.join({td!r}, "ref.pkl"), "wb") as f:
    pickle.dump({{p: o for p, o in zip(paths, outs)}}, f)
print("ref done")
"""], env=env_base, capture_output=True, text=True, timeout=900)
        print(ref.stdout.strip(), ref.stderr.strip()[-300:] or "")
        assert ref.returncode == 0

        import pickle

        with open(os.path.join(td, "ref.pkl"), "rb") as f:
            want = pickle.load(f)
        got = {}
        for pid in range(2):
            with open(os.path.join(td, f"out_{pid}.pkl"), "rb") as f:
                got.update(pickle.load(f))
        assert set(got) == set(want), (len(got), len(want))
        worst = 0
        for p in want:
            d = np.abs(got[p].astype(int) - want[p].astype(int))
            worst = max(worst, int(d.max()))
        # Cross-process partitioning moves jit boundaries/FMA placement:
        # hold to the repo's cross-path <=1 LSB contract.
        assert worst <= 1, worst
        print(f"TWO-PROCESS MULTIHOST OK: {len(want)} files (3 mixed "
              f"shape buckets, one single-host) across 2 hosts x 4 "
              f"devices, outputs within {worst} LSB of BatchEngine")


if __name__ == "__main__":
    main()
