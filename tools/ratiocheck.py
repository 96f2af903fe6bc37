#!/usr/bin/env python
"""ratiocheck — compression-ratio impact of tokenizer knobs (CPU backend).

Ratio is backend-independent, so variants are evaluated on the CPU backend
where compiles are cheap; speed is measured on the GPU separately.

Usage:
  JAX_PLATFORMS=cpu python tools/ratiocheck.py --ctx 4 --seg 8192 --probes 6
  JAX_PLATFORMS=cpu python tools/ratiocheck.py --corpus strided
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import zlib

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def strided_corpus(mb: int = 8) -> bytes:
    """Fixed-stride records (the round-1 ratio weakness: 333-byte period)."""
    rng = np.random.default_rng(3)
    rec = rng.integers(0, 256, 333, dtype=np.uint8)
    n = (mb << 20) // 333 + 1
    rows = np.tile(rec, (n, 1))
    # per-record mutation: a few fields change
    rows[:, 7] = np.arange(n) & 0xFF
    rows[:, 100] = (np.arange(n) >> 8) & 0xFF
    rows[:, 200] = rng.integers(0, 256, n, dtype=np.uint8)
    return rows.tobytes()[: mb << 20]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--ctx", type=int, default=4)
    p.add_argument("--seg", type=int, default=8192)
    p.add_argument("--probes", type=int, default=6)
    p.add_argument("--search-seg", type=int, default=0)
    p.add_argument("--search-overlap", type=int, default=1024)
    p.add_argument("--search-stride", type=int, default=1)
    p.add_argument("--mb", type=int, default=8)
    p.add_argument("--corpus", default="mixed", choices=["mixed", "strided"])
    args = p.parse_args()

    import jax
    # ratio is backend-independent: run on the CPU so ratio sweeps never
    # take a GPU from a device process
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from qatzip_tpu.ops.lz77 import lz77_tokenize, merge_segment_tokens
    from qatzip_tpu import native

    if args.corpus == "strided":
        blob = strided_corpus(args.mb)
    else:
        from bench import make_corpus
        blob = make_corpus(args.mb)
    n = 65536
    b = len(blob) // n
    data = np.zeros((b, n), np.uint8)
    mv = memoryview(blob)
    for i in range(b):
        data[i] = np.frombuffer(mv[i * n:(i + 1) * n], np.uint8)
    lengths = np.full(b, n, np.int32)

    toks, ntok = lz77_tokenize(jnp.asarray(data), jnp.asarray(lengths), n=n,
                               parse_seg=args.seg, ctx_words=args.ctx,
                               probes=args.probes,
                               search_seg=args.search_seg,
                               search_overlap=args.search_overlap,
                               search_stride=args.search_stride)
    toks = np.asarray(toks)
    ntok = np.asarray(ntok)
    total = 0
    for i in range(b):
        row = merge_segment_tokens(toks[i], ntok[i], args.seg)
        payload = native.lib.deflate_pack(data[i].tobytes(), row, len(row),
                                          final=True, mode=0)
        # verify
        assert zlib.decompressobj(-15).decompress(payload) == \
            data[i].tobytes(), f"row {i} mismatch"
        total += len(payload)
    zl = sum(len(zlib.compress(data[i].tobytes(), 1)) for i in range(b))
    ours = b * n / total
    zratio = b * n / zl
    print(json.dumps({
        "corpus": args.corpus, "ctx": args.ctx, "seg": args.seg,
        "probes": args.probes, "search_seg": args.search_seg,
        "search_overlap": args.search_overlap,
        "search_stride": args.search_stride,
        "mb": b * n >> 20,
        "ratio": round(ours, 4), "zlib_l1_ratio": round(zratio, 4),
        "vs_zlib_l1": round(ours / zratio, 4),
    }))


if __name__ == "__main__":
    main()
