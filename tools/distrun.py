#!/usr/bin/env python
"""distrun — an ACTUALLY EXECUTED multi-process jax.distributed run.

The reference proves process-DP by running N processes and summing their
Gbps (test/performance_tests/run_perf_test.sh:106-125). This driver does
the same with the jax.distributed coordination layer doing the process
bring-up: it launches N worker processes (CPU backend, localhost
coordinator), each worker

  1. calls jax.distributed.initialize(...) and asserts process_count == N,
  2. participates in a cross-process psum over a global 1-D mesh (the
     offsets/stats exchange of parallel/multihost.py, executed for real),
  3. compresses its round-robin chunk stripe (parallel.multihost.
     compress_striped) and reports bytes + wall time,

and the parent interleaves the stripes back into submission order,
verifies every member decodes byte-exact with stock zlib, and prints the
summed Gbps line (the awk-sum analog).

Usage:
    python tools/distrun.py --procs 2 --mb 16          # SW codec (fast, CI)
    python tools/distrun.py --procs 2 --engine device  # one GPU per worker

With ``--engine device`` each worker sees only its own GPU
(CUDA_VISIBLE_DEVICES): a JAX process reserves most of a card's memory, so
two workers cannot share one, and more workers than GPUs is refused.

Exit code 0 = distributed init + collective + round-trip all verified.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
import zlib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


WORKER = r"""
import os, pickle, sys, time
import jax
if os.environ.get("QZTPU_FORCE_SW") == "1":
    # the software codec needs no device: keep the worker off any card
    jax.config.update("jax_platforms", "cpu")

coord = os.environ["QZTPU_COORD"]
nprocs = int(os.environ["QZTPU_NPROCS"])
pid = int(os.environ["QZTPU_PID"])

from qatzip_tpu.parallel.multihost import (init_distributed,
                                           compress_striped)

got_pid, got_n = init_distributed(coordinator_address=coord,
                                  num_processes=nprocs, process_id=pid)
assert (got_pid, got_n) == (pid, nprocs), (got_pid, got_n)
assert jax.process_count() == nprocs

# cross-process collective: psum of per-host byte counts over the global
# mesh — the stats/offset exchange of the multihost design, executed
import numpy as np
with open(os.environ["QZTPU_CHUNKS"], "rb") as f:
    chunks = pickle.load(f)

# process_allgather runs a real cross-process allgather through the
# distributed runtime (Gloo on the CPU backend) — every process receives
# every host's byte count and must agree on the global total
from jax.experimental import multihost_utils
local = np.asarray([sum(len(c) for c in chunks[pid::nprocs])], np.int32)
gathered = np.asarray(multihost_utils.process_allgather(local))
tot = int(gathered.sum())
assert gathered.shape[0] == nprocs
assert tot == sum(len(c) for c in chunks), (tot, sum(len(c) for c in chunks))

t0 = time.perf_counter()
idx, results = compress_striped(chunks, algorithm="deflate", level=1)
dt = time.perf_counter() - t0
nbytes = sum(len(chunks[i]) for i in idx)

with open(os.environ["QZTPU_OUT"], "wb") as f:
    pickle.dump({"pid": pid, "idx": idx, "results": results,
                 "sec": dt, "bytes": nbytes, "psum_ok": True}, f)
print(f"worker {pid}: {nbytes} bytes in {dt*1000:.0f} ms = "
      f"{nbytes*8/dt/1e9:.2f} Gbps", flush=True)
"""


def gpu_count() -> int:
    """GPUs on this host, read without starting JAX in the parent."""
    try:
        r = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return 0
    if r.returncode != 0:
        return 0
    return sum(1 for ln in r.stdout.splitlines() if ln.startswith("GPU "))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--mb", type=int, default=16)
    ap.add_argument("--engine", choices=["sw", "device"], default="sw")
    ap.add_argument("--chunk-kb", type=int, default=64)
    args = ap.parse_args()
    if args.engine == "device":
        ngpu = gpu_count()
        if args.procs > ngpu:
            sys.exit(f"distrun: {args.procs} device workers need one GPU "
                     f"each; found {ngpu}")

    from bench import make_corpus  # noqa: E402  (repo-root import)
    blob = make_corpus(args.mb)
    ck = args.chunk_kb * 1024
    chunks = [blob[o:o + ck] for o in range(0, len(blob), ck)]

    tmp = tempfile.mkdtemp(prefix="qztpu_dist_")
    chunks_path = os.path.join(tmp, "chunks.pkl")
    with open(chunks_path, "wb") as f:
        pickle.dump(chunks, f)

    port = free_port()
    procs = []
    outs = []
    for pid in range(args.procs):
        out = os.path.join(tmp, f"out{pid}.pkl")
        outs.append(out)
        env = dict(os.environ,
                   QZTPU_COORD=f"127.0.0.1:{port}",
                   QZTPU_NPROCS=str(args.procs),
                   QZTPU_PID=str(pid),
                   QZTPU_CHUNKS=chunks_path,
                   QZTPU_OUT=out,
                   PYTHONPATH=REPO)
        if args.engine == "sw":
            env["QZTPU_FORCE_SW"] = "1"  # software codec: no device compiles
        else:
            env["CUDA_VISIBLE_DEVICES"] = str(pid)   # one card per worker
        procs.append(subprocess.Popen([sys.executable, "-c", WORKER],
                                      env=env, cwd=REPO))
    rc = [p.wait(timeout=600) for p in procs]
    if any(rc):
        print(json.dumps({"ok": False, "rc": rc}))
        sys.exit(1)

    # interleave stripes back into global submission order + verify
    from qatzip_tpu.parallel.multihost import interleave_stripes
    stripes = []
    total_gbps = 0.0
    for out in outs:
        with open(out, "rb") as f:
            d = pickle.load(f)
        assert d["psum_ok"]
        stripes.append(d["results"])
        total_gbps += d["bytes"] * 8 / d["sec"] / 1e9
    merged = interleave_stripes(stripes, len(chunks))
    for (payload, crc), src in zip(merged, chunks):
        assert zlib.decompressobj(-15).decompress(payload) == src
        assert crc == (zlib.crc32(src) & 0xFFFFFFFF)

    print(json.dumps({
        "ok": True, "procs": args.procs, "chunks": len(chunks),
        "mb": args.mb, "engine": args.engine,
        "sum_gbps": round(total_gbps, 2),
        "verified": "stock zlib round-trip, submission order"}))


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
