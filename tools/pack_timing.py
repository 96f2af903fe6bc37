#!/usr/bin/env python
"""Time the static device pack and its window-assembly scatter on one
device, at the engine's tile shape (256 rows x 64 KB, deflate L1 knobs).

    python tools/pack_timing.py [--rows 256] [--iters 20]

Prints one JSON line: the device, the median seconds of the whole static
pack step (``deflate_pack_device``: tokenizer analysis, emission, group
pack and assembly), the median seconds of the assembly scatter-add alone,
the assembly's share of the step, and for context the median seconds of
the token path's ``lz77_tokenize`` on the same tile. The assembly is timed on group
windows of the same shape and with word offsets of the same density as
the real step (offsets follow each row's real bit count, spread evenly
over its groups), so its scatter moves the same number of words into the
same number of rows.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _median_s(fn, args, iters: int) -> float:
    import jax

    jax.block_until_ready(fn(*args))          # compile + warm
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=256)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, REPO)

    import jax
    import jax.numpy as jnp

    from qatzip_tpu.ops.deflate_pack import GROUP, GROUP_W, deflate_pack_device
    from qatzip_tpu.ops.lz77 import lz77_tokenize
    from qatzip_tpu.parallel.dispatch import _tok_knobs
    from chip_smoke import _load_corpus_module

    make_silesia_like = _load_corpus_module().make_silesia_like

    b, n = args.rows, 65536
    blob = make_silesia_like((b * n >> 20) + 4)   # reps of a ~4 MB unit
    data = np.frombuffer(blob[:b * n], np.uint8).reshape(b, n)
    dd = jax.device_put(data)
    ll = jax.device_put(np.full(b, n, np.int32))
    ss, ov, cs, ctx, probes = _tok_knobs(1, n)
    kw = dict(n=n, search_seg=ss, search_overlap=ov, ctx_words=ctx,
              probes=probes)
    max_words = (n * 9 + 3 + 7 + 31) // 32 + 2

    step = jax.jit(lambda d, l: deflate_pack_device(d, l, **kw))
    step_s = _median_s(step, (dd, ll), args.iters)
    _words, nbits = step(dd, ll)
    nbits = np.asarray(nbits)
    tok = jax.jit(lambda d, l: lz77_tokenize(d, l, compact_seg=cs, **kw))
    tok_s = _median_s(tok, (dd, ll), args.iters)

    ngroups = n // GROUP
    rng = np.random.default_rng(0)
    grp = jax.device_put(rng.integers(0, 2**32, (b, ngroups, GROUP_W),
                                      dtype=np.uint64).astype(np.uint32))
    per_group = nbits[:, None] / ngroups
    wo = (np.arange(ngroups)[None, :] * per_group).astype(np.int32) >> 5
    wo = jax.device_put(wo)

    @jax.jit
    def assemble(grp, wo):
        # the scatter-add of deflate_pack._group_pack_assemble
        out = jnp.zeros((b, max_words), jnp.uint32)
        widx = wo[:, :, None] + jnp.arange(GROUP_W, dtype=jnp.int32)[None,
                                                                     None, :]
        return out.at[jnp.arange(b)[:, None, None], widx].add(grp,
                                                              mode="drop")

    asm_s = _median_s(assemble, (grp, wo), args.iters)
    dev = jax.devices()[0]
    print(json.dumps({
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "rows": b, "row_bytes": n, "iters": args.iters,
        "static_pack_step_s": step_s, "assembly_s": asm_s,
        "token_path_tokenize_s": tok_s,
        "assembly_share": asm_s / step_s,
        "step_mb_per_s": b * n / step_s / 1e6,
    }))


if __name__ == "__main__":
    main()
