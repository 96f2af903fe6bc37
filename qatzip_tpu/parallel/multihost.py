"""Multi-process chunk distribution.

The reference scales by N processes × M threads on one node, with the perf
harness summing per-process Gbps (test/performance_tests/run_perf_test.sh:
53-125). Here ``jax.distributed`` brings up the processes, each process
compresses the chunk-stripe it owns with its local GPUs (no cross-process
traffic on the data path), and the stitcher reassembles members in
submission order — offsets are exchanged via a tiny gathered stats array,
the only cross-process collective. Processes that share a host each need
a GPU of their own (the launcher sets CUDA_VISIBLE_DEVICES; see
tools/distrun.py): a JAX process reserves most of a card's memory.

Design notes: chunks are independent, so the mesh is 1-D ``dp`` over every
device; the per-process stripe is
``chunks[host_id::num_hosts]`` ... striped round-robin so file tails don't
skew one host. Compressed members stay host-local; the caller concatenates
stripe outputs in stripe order (equivalent to the ordered retirement of
doCompressOut, src/qatzip.c:1733-1750) or writes a multi-member container
where member order is stripe-major.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> Tuple[int, int]:
    """Bring up jax.distributed (idempotent). Returns (pid, nprocs).

    With no arguments, reads QZTPU_NUM_PROCESSES / QZTPU_PROCESS_ID; with
    one process it is a no-op returning (0, 1).
    """
    import jax

    if num_processes is None:
        num_processes = int(os.environ.get("QZTPU_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return 0, 1
    if process_id is None:
        process_id = int(os.environ.get("QZTPU_PROCESS_ID", "0"))
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
    except RuntimeError:
        pass  # already initialized
    return jax.process_index(), jax.process_count()


def host_stripe(num_items: int, pid: int, nprocs: int) -> List[int]:
    """Round-robin stripe of chunk indices owned by this host."""
    return list(range(pid, num_items, nprocs))


def compress_striped(chunks: Sequence[bytes], *, algorithm: str = "deflate",
                     level: int = 1, huffman_static: bool = False,
                     mini_match: int = 3):
    """Compress this host's stripe of a global chunk list.

    Returns (stripe_indices, [(payload, crc32), ...]) for the chunks this
    host owns. A coordinator (or shared filesystem) interleaves stripes
    back into global submission order:
        results[global_i] = stripe_of(host = global_i % nprocs)[global_i // nprocs]
    """
    import jax

    pid, nprocs = jax.process_index(), jax.process_count()
    idx = host_stripe(len(chunks), pid, nprocs)
    mine = [chunks[i] for i in idx]
    from ..runtime import get_runtime

    rt = get_runtime()
    if not rt.initialized:
        rt.init(1)
    eng = rt.get_engine(algorithm)
    if eng is None:
        from ..engines import host_engine
        eng = host_engine
    results = eng.compress_chunks(mine, level=level, algorithm=algorithm,
                                  huffman_static=huffman_static,
                                  mini_match=mini_match)
    # engine payloads may be zero-copy views into a native staging
    # buffer (round-5 batch compress); this result crosses a process
    # boundary (pickled stripe), so materialize bytes here
    return idx, [(bytes(p), c) for p, c in results]


def interleave_stripes(stripes: Sequence[Sequence], num_items: int) -> List:
    """Reassemble per-host stripe outputs into global submission order."""
    nprocs = len(stripes)
    out = [None] * num_items
    for pid, stripe in enumerate(stripes):
        for k, item in enumerate(stripe):
            out[pid + k * nprocs] = item
    return out
