"""Compression engines: the uniform chunk-batch interface.

The dispatch layer (codec.py) fans a request into hw_buff_sz chunks and
hands the whole batch to an engine — the analog of the reference's
submit/poll hot loops (doCompressIn/doCompressOut, src/qatzip.c:1336-1887)
where a request becomes a sequence-numbered batch of device operations and
completions are stitched in order.

Engines:
  * HostEngine — multithreaded zlib/native-LZ4 (the SW instance pool)
  * DeviceEngine — built by qatzip_tpu.parallel.dispatch (batched XLA
    programs on the accelerator)
"""

from __future__ import annotations

import concurrent.futures as _fut
import os
import threading
import zlib
from typing import List, Optional, Sequence, Tuple

from .constants import effective_deflate_sw_level
from .ops import crc32
from .sw.codec import deflate_raw_compress, inflate_raw


_pool_lock = threading.Lock()
_pool: Optional[_fut.ThreadPoolExecutor] = None


def host_pool() -> _fut.ThreadPoolExecutor:
    """Shared worker pool — the SW 'instance ring'. zlib and the native
    LZ4 codecs release the GIL, so threads scale across cores the way the
    reference's N-process × M-thread perf harness does."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = _fut.ThreadPoolExecutor(
                max_workers=max(4, (os.cpu_count() or 8)))
        return _pool


class HostEngine:
    """Software chunk engine (qatzip_sw.c as a batch service)."""

    name = "host"

    def compress_chunks(self, chunks: Sequence[bytes], *, level: int,
                        algorithm: str = "deflate",
                        final_flags: Optional[Sequence[bool]] = None,
                        mini_match: int = 3,
                        huffman_static: bool = False,
                        sw_coder: Optional[str] = None,
                        ) -> List[Tuple[bytes, int]]:
        """Compress each chunk to an independent raw payload + its crc32.

        For deflate, each chunk is a complete raw stream (BFINAL set) when
        its final flag is true, else a full-flushed non-final segment —
        matching the reference's FLUSH_FULL/FLUSH_FINAL per-chunk policy
        (src/qatzip.c:1384-1394).

        Payloads are bytes-like and may be zero-copy views into a native
        staging buffer (the one-call batch path); callers that cross a
        process boundary must materialize with bytes().
        """
        zlevel = effective_deflate_sw_level(level)
        finals = final_flags or [True] * len(chunks)

        from . import native as _native
        # SW deflate coder: the native matcher + package-merge packer
        # (qz_lz77_host + qz_deflate_pack mode 0) measures ~zlib-L1 speed
        # at ~+8% ratio per core on mixed data, so speed levels (1-5)
        # default to it; levels >= 6 keep zlib's deeper search, and
        # QZTPU_SW_CODER=zlib restores bit-exact zlib output everywhere
        # (the reference's SW path is stock zlib, src/qatzip_sw.c).
        # ``sw_coder`` overrides the env knob — CnV fallbacks force
        # "zlib" so a failing native packer can never re-encode its own
        # verification failure (the independent-implementation rule).
        coder = sw_coder or os.environ.get("QZTPU_SW_CODER", "native")
        use_native_coder = (
            algorithm == "deflate" and _native.lib is not None
            and zlevel <= 5 and coder == "native")
        # level ladder (measured, mixed corpus, per core): 1-3 greedy
        # chain-4 (90 MB/s @ 3.369 — above zlib L1-L3); 4-5 greedy
        # chain-16 (60 @ 3.460 vs zlib L4 55 @ 3.407). The lazy variant
        # (negative chain, deflate_slow-style) measured 34 @ 3.473 at 16
        # — only +0.4% ratio for half the speed, so greedy keeps the
        # ladder; lazy-32 (26 @ 3.504) is the measured option should a
        # future level want near-zlib-L6 ratio at 3x its speed.
        chain = 4 if zlevel <= 3 else 16

        def one(args):
            chunk, final = args
            if algorithm == "deflate":
                if use_native_coder and chunk:
                    toks = _native.lib.lz77_host(chunk, chain=chain)
                    payload = _native.lib.deflate_pack(
                        chunk, toks, len(toks), final=final, mode=0)
                elif final:
                    payload = deflate_raw_compress(chunk, zlevel)
                else:
                    co = zlib.compressobj(zlevel, zlib.DEFLATED, -15)
                    payload = co.compress(chunk) + co.flush(zlib.Z_FULL_FLUSH)
                return payload, crc32(chunk)
            if algorithm == "lz4":
                from .sw.codec import _lz4_block_compress
                return _lz4_block_compress(chunk), crc32(chunk)
            if algorithm == "lz4s":
                from . import native
                if native.lib is not None:
                    payload = native.lib.lz4s_compress_block(chunk, mini_match)
                else:
                    from .sw.lz4_py import lz4s_compress_block_py
                    payload = lz4s_compress_block_py(chunk, mini_match)
                return payload, crc32(chunk)
            raise ValueError(algorithm)

        items = list(zip(chunks, finals))
        if len(items) <= 1:
            return [one(a) for a in items]
        if use_native_coder and all(len(c) for c in chunks):
            # whole batch in ONE GIL-free native call (matcher + packer +
            # crc on a native pool) — drops the per-chunk Python round
            # trips (3 calls + a future each), measured ~30% of the
            # pooled path on the 48 MB bench request
            batched = _native.lib.deflate_compress_batch(
                chunks, [1 if f else 0 for f in finals], chain=chain,
                mode=0)
            if batched is not None:
                payloads, crcs = batched
                return [(p, int(c)) for p, c in zip(payloads, crcs)]
        if (algorithm in ("lz4", "lz4s") and _native.lib is not None
                and all(len(c) for c in chunks)):
            batched = _native.lib.lz4_compress_batch(
                chunks, fmt=algorithm, mini_match=mini_match)
            if batched is not None:
                payloads, crcs = batched
                return [(p, int(c)) for p, c in zip(payloads, crcs)]
        return list(host_pool().map(one, items))

    def decompress_chunks(self, payloads: Sequence[bytes],
                          expected_sizes: Sequence[int], *,
                          algorithm: str = "deflate") -> List[bytes]:
        """Decode independent raw payloads (ordered retirement is the
        caller's list order — the seq-number stitch of doDecompressOut)."""
        from . import native as _native

        def one(args):
            payload, sz = args
            if algorithm == "deflate":
                # fast native inflate (csrc qz_inflate_raw, ~2x zlib);
                # malformed input falls back to zlib for exact rc/message
                if _native.lib is not None and sz >= 0:
                    out = _native.lib.inflate_raw(payload, sz)
                    if out is not None:
                        return out
                return inflate_raw(payload, sz if sz >= 0 else None)
            if algorithm == "lz4":
                from .sw.codec import _lz4_block_decompress
                return _lz4_block_decompress(payload, sz)
            raise ValueError(algorithm)

        items = list(zip(payloads, expected_sizes))
        if len(items) <= 1:
            return [one(a) for a in items]
        return list(host_pool().map(one, items))


host_engine = HostEngine()
