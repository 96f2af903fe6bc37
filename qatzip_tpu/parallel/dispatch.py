"""Accelerated chunk engine — the per-instance submit/poll machinery
analog (src/qatzip.c:1336-1887). The dispatch layer (codec.py) fans a
request into ``hw_buff_sz`` chunks; this engine tiles the batch (device
"ring depth" = TILE_B, the 32/128-deep buffer-ring analog) and runs one
of three compress paths:

  * token path (default for dynamic sessions): batched LZ77 tokenize on
    device (ops/lz77.py), entropy pack on the host with the native C++
    packers (csrc) in parallel threads — XLA's async queue pipelines tile
    k+1's device work under tile k's host pack,
  * full-device deflate (QZTPU_DEVICE_PACK, ops/deflate_pack.py): static
    or per-chunk-dynamic Huffman bitstreams assembled on device, d2h
    carries final compressed words (the QAT single-call-compress analog,
    src/qatzip.c:1445); static packs shard over the dp mesh,
  * full-device LZ4 (ops/lz4_pack.py): final block bytes on device with
    per-chunk host fallback for long-literal-run chunks.

Results return (payload, crc32) per chunk in submission order — the
ordered retirement invariant of doCompressOut (src/qatzip.c:1733-1750).
Decompression routes through ``decompress_chunks``: batched GIL-free
native decode on the host, with a device LZ4 leg (QZTPU_DEVICE_DECODE).

Optional compress-and-verify (QZTPU_CNV=1) decodes every payload and
compares against the source — the reference runs CnV on every request in
hardware (src/qatzip.c:1387) and falls back to stored blocks on failure;
we fall back per chunk the same way.
"""

from __future__ import annotations

import os
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.debug import qz_log


# chunks per device dispatch; 256 amortizes the per-dispatch sync latency
TILE_B = int(os.environ.get("QZTPU_TILE_B", "256"))

# full tiles chained per device dispatch via lax.scan — the deeper
# submission ring (reference: NUM_BUFF=32 requests in flight per
# instance, qatzip_internal.h:63-68). One dispatch covers K tiles while
# the scan body reuses a single tile's buffers, so per-dispatch overhead
# amortizes K-fold with no extra device-memory pressure (a larger
# QZTPU_TILE_B would grow the live set instead). 1 disables grouping.
SCAN_TILES = int(os.environ.get("QZTPU_SCAN_TILES", "4"))


def _bucket(b: int) -> int:
    p = 1
    while p < b:
        p <<= 1
    return min(p, TILE_B)


def _pow2_chunk_n(chunks) -> int:
    """Smallest power-of-two row capacity covering every chunk (>=256)."""
    n = 1
    for c in chunks:
        while n < len(c):
            n <<= 1
    return max(n, 256)


def _stage_tile(tile, b: int, n: int):
    """Zero-padded (b, n) staging batch + per-row lengths for one tile."""
    data = np.zeros((b, n), np.uint8)
    lengths = np.zeros(b, np.int32)
    for i, c in enumerate(tile):
        a = np.frombuffer(c, np.uint8)
        data[i, :len(a)] = a
        lengths[i] = len(a)
    return data, lengths


def _fetch_bucket(maxv: int, cap: int) -> int:
    """Power-of-two fetch width (min 256) so d2h slice programs stay
    cached across tiles."""
    k = 256
    while k < maxv:
        k <<= 1
    return min(k, cap)


def _tok_knobs(level: int, n: int):
    """Per-level tokenizer knobs: (search_seg, search_overlap,
    compact_seg, ctx_words, probes).

    Levels <= 5 window the candidate search (8K windows, 896 overlap —
    896 is the largest overlap that still tiles a 64K row in NINE 8K
    windows instead of ten, so it searches 10% fewer elements than
    ov=1024 at measurably identical ratio) and carry 12 bytes of sort
    context with 7 probes instead of 16 bytes with 6: the candidate
    sort's cost grows with carried-operand bytes, and ctx3+probes7
    prices at -0.03% ratio vs ctx4+probes6
    on the mixed corpus (tools/ratiocheck.py: 1.0649 vs 1.0652x zlib L1;
    strided corpus unchanged at 1.036x). Levels >= 6 keep the full
    32K-reach search with 16-byte context, like the reference maps its
    levels onto one hardware search and leaves ratio to the request path
    (README.md:109-114). Compaction segmentation never changes the token
    stream (tests/test_lz77_tpu.py) and is always on for 64K rows.
    Env overrides: QZTPU_SEARCH_SEG / QZTPU_SEARCH_OV / QZTPU_COMPACT_SEG
    / QZTPU_CTX_WORDS / QZTPU_PROBES.
    """
    fast = level <= 5
    ss = int(os.environ.get("QZTPU_SEARCH_SEG", "-1"))
    ov = int(os.environ.get("QZTPU_SEARCH_OV", "-1"))
    cs = int(os.environ.get("QZTPU_COMPACT_SEG", "-1"))
    ctx = int(os.environ.get("QZTPU_CTX_WORDS", "-1"))
    probes = int(os.environ.get("QZTPU_PROBES", "-1"))
    if ss < 0:
        ss = 8192 if fast else 0
    if ov < 0:
        ov = 896 if fast else 1024
    if cs < 0:
        cs = 512
    if ss >= n:
        # full reach for small chunks — clamp BEFORE deriving ctx/probes
        # so they fall back to the full-reach values (ctx4/probes6): the
        # ctx3/probes7 ratio-neutrality was only measured under the 8K
        # windowed search.
        ss = 0
    if ctx < 0:
        ctx = 3 if fast and ss else 4
    if probes < 0:
        probes = 7 if fast and ss else 6
    if cs >= n:
        cs = 0
    return ss, ov, cs, ctx, probes


def _tok_speed(level: int, n: int):
    """Back-compat 3-tuple view of :func:`_tok_knobs`."""
    return _tok_knobs(level, n)[:3]


class DeviceEngine:
    """Chunk-batch engine backed by the JAX device runtime.

    The host half of every device path (token packing, tree building,
    member framing) runs in the native library, so the engine refuses to
    exist without it rather than quietly compressing on the host."""

    name = "device"

    def __init__(self, devices, algorithm: str):
        from .. import native

        if native.lib is None:
            raise RuntimeError("device engine needs the native library: "
                               + (native.build_error or "not loaded"))
        self.devices = list(devices)
        self.algorithm = algorithm
        self._cnv_default = os.environ.get("QZTPU_CNV", "0") == "1"
        # device-side CRC32 (GF(2) matmul, ops/crc32_mxu.py): exact vs
        # zlib, opt-in — host crc32 rides the packing threads for free
        self._device_crc = os.environ.get("QZTPU_DEVICE_CRC", "0") == "1"
        # QZTPU_DEVICE_PACK — device-side entropy packing
        # (ops/deflate_pack.py): d2h carries final compressed words
        # instead of tokens and the host only frames members — the
        # QAT-silicon single-call-compress analog (src/qatzip.c:1445).
        # "auto" (default): static-Huffman sessions compress entirely on
        # device; "1": force for ALL deflate sessions (dynamic sessions
        # use the two-pass per-chunk-tree dynamic device packer, ratio
        # parity with the host packer); "0": host packer always.
        # Read per call so benchmarks/tests can flip it on a live engine.

    # -- tokenizer params per algorithm -------------------------------------
    @staticmethod
    def _tok_params(algorithm: str):
        if algorithm == "deflate":
            return dict(min_match=4, max_match=258, window=32768)
        # LZ4/LZ4s: 32KB history (reference windowSize=7,
        # src/qatzip_utils.c:270); token field caps match length at 15 bits
        return dict(min_match=4, max_match=32767, window=32768)

    # -- device stage ---------------------------------------------------------
    def _tokenize_tiles(self, chunks: Sequence[bytes], n: int, algorithm: str,
                        level: int = 1):
        """Yield (tile_start, np tokens, np ntok, crcs) per tile.

        All tiles are dispatched eagerly; XLA's async queue overlaps the
        device work with the caller's host-side packing of earlier tiles.
        The fetch is two-phase: ntok (tiny) first, then only the used token
        prefix, rounded to a bucket so slice programs stay cached — device→
        host bandwidth is the scarce resource (SURVEY.md §5: host transfer
        minimization is the pinned-memory analog). With compact_seg the
        tokens come back segment-compacted: (b, nseg, k) slices + (b, nseg)
        counts, stitched by merge_segment_tokens in the pack stage.
        """
        import jax.numpy as jnp
        from ..ops.lz77 import lz77_tokenize, lz77_tokenize_scan

        params = self._tok_params(algorithm)
        seg = min(8192, n)
        ss, ov, cs, ctx, probes = _tok_knobs(level, n)
        kw = dict(parse_seg=seg, search_seg=ss, search_overlap=ov,
                  compact_seg=cs, ctx_words=ctx, probes=probes, **params)
        ndev = len(self.devices)
        mesh = None
        if ndev > 1:
            # multi-chip: shard the tile's batch axis over the dp mesh
            # (chunk-DP — the instance-pool shuffle analog)
            from .mesh import make_mesh
            mesh = make_mesh(self.devices)
        starts = list(range(0, len(chunks), TILE_B))
        pending = []
        i = 0
        while i < len(starts):
            start = starts[i]
            # scan-group consecutive FULL tiles (single device only):
            # one dispatch covers up to SCAN_TILES tiles (see SCAN_TILES)
            if (mesh is None and not self._device_crc and SCAN_TILES > 1
                    and len(chunks) - start >= 2 * TILE_B):
                grp = []
                while (len(grp) < SCAN_TILES and i + len(grp) < len(starts)
                       and len(chunks) - starts[i + len(grp)] >= TILE_B):
                    grp.append(starts[i + len(grp)])
                datas = np.zeros((len(grp), TILE_B, n), np.uint8)
                lens = np.zeros((len(grp), TILE_B), np.int32)
                for g, s in enumerate(grp):
                    datas[g], lens[g] = _stage_tile(
                        chunks[s:s + TILE_B], TILE_B, n)
                toks, ntok = lz77_tokenize_scan(
                    jnp.asarray(datas), jnp.asarray(lens), n=n, **kw)
                pending.append(("grp", grp, toks, ntok))
                i += len(grp)
                continue
            tile = chunks[start:start + TILE_B]
            b = _bucket(len(tile))
            if mesh is not None and b % ndev:
                b = ((b + ndev - 1) // ndev) * ndev  # divisible batch
            # NOTE: tile staging deliberately does NOT draw from the
            # BufferPool: on the CPU backend jnp.asarray may alias the
            # numpy buffer zero-copy (the PINNED case of the reference's
            # qzMemFindAddr decision), so recycling it after dispatch
            # would corrupt in-flight device input. Pooled reuse lives in
            # the per-chunk pack staging (native.py) and stream staging.
            data, lengths = _stage_tile(tile, b, n)
            i += 1
            if mesh is not None:
                from .mesh import mesh_tokenize
                toks, ntok, _stats = mesh_tokenize(
                    mesh, data, lengths, n=n, search_seg=ss,
                    search_overlap=ov, ctx_words=ctx, probes=probes,
                    **params)
                dcrc = None
                pending.append(("one", start, len(tile), toks, ntok, dcrc,
                                lengths))
                continue
            darr = jnp.asarray(data)
            toks, ntok = lz77_tokenize(darr, jnp.asarray(lengths), n=n,
                                       **kw)
            dcrc = None
            if self._device_crc:
                from ..ops.crc32_mxu import crc32_batch_device
                dcrc = crc32_batch_device(darr, n=n)
            pending.append(("one", start, len(tile), toks, ntok, dcrc,
                            lengths))
        for item in pending:
            if item[0] == "grp":
                _tag, grp, toks_k, ntok_k = item
                yield from self._fetch_group(grp, toks_k, ntok_k,
                                             len(chunks), n)
                continue
            _tag, start, nt, toks, ntok, dcrc, lens_np = item
            crcs = [None] * nt
            if dcrc is not None:
                dcrc_np = np.asarray(dcrc)
                for i in range(nt):
                    if lens_np[i] == n:  # full rows only (padding-exact)
                        crcs[i] = int(dcrc_np[i])
            ntok_np = np.asarray(ntok)
            if ntok_np.ndim == 2 and ntok_np.shape[1] > 1:
                # segment-compacted layout: fetch each segment's used
                # prefix; fall back to the full row when a dense segment
                # would make the sliced fetch larger than the row
                b_, ncs = ntok_np.shape
                cseg = n // ncs
                kmax = int(ntok_np.max()) if nt else 0
                k = _fetch_bucket(kmax, cseg)
                if k * ncs >= n:
                    yield start, nt, np.asarray(toks).reshape(
                        b_, ncs, cseg), ntok_np, crcs
                else:
                    sl = toks.reshape(b_, ncs, cseg)[:, :, :k]
                    yield start, nt, np.asarray(sl), ntok_np, crcs
                continue
            ntok_np = ntok_np.ravel()                # (b,) per-row counts
            kmax = int(ntok_np.max()) if nt else 0
            k = _fetch_bucket(kmax, n)
            yield start, nt, np.asarray(toks[:, :k]), ntok_np, crcs

    def _fetch_group(self, grp, toks_k, ntok_k, nchunks: int, n: int):
        """Bucketed d2h fetch for a scan group: ntok first (tiny), then
        one token-prefix slice covering all K tiles (same slice-program
        caching rationale as the single-tile fetch)."""
        ntok_np = np.asarray(ntok_k)          # (K, b) or (K, b, ncs)
        nk = ntok_np.shape[0]
        if ntok_np.ndim == 3 and ntok_np.shape[2] > 1:
            _k, b_, ncs = ntok_np.shape
            cseg = n // ncs
            kmax = int(ntok_np.max()) if ntok_np.size else 0
            kb = _fetch_bucket(kmax, cseg)
            if kb * ncs >= n:
                toks_np = np.asarray(toks_k).reshape(nk, b_, ncs, cseg)
            else:
                toks_np = np.asarray(
                    toks_k.reshape(nk, b_, ncs, cseg)[:, :, :, :kb])
            for g, s in enumerate(grp):
                nt = min(TILE_B, nchunks - s)
                yield s, nt, toks_np[g], ntok_np[g], [None] * nt
            return
        ntok_np = ntok_np.reshape(nk, -1)
        kmax = int(ntok_np.max()) if ntok_np.size else 0
        kb = _fetch_bucket(kmax, n)
        toks_np = np.asarray(toks_k[:, :, :kb])
        for g, s in enumerate(grp):
            nt = min(TILE_B, nchunks - s)
            yield s, nt, toks_np[g], ntok_np[g], [None] * nt

    # -- public engine interface ----------------------------------------------
    def compress_chunks(self, chunks: Sequence[bytes], *, level: int,
                        algorithm: str = "deflate",
                        final_flags: Optional[Sequence[bool]] = None,
                        mini_match: int = 3,
                        huffman_static: bool = False,
                        cnv: Optional[bool] = None,
                        ) -> List[Tuple[bytes, int]]:
        """Compress each chunk to an independent payload + its crc32.

        ``level`` is accepted for interface parity but does not change the
        device matcher (the reference likewise maps levels 1-8 onto the
        same hardware search, README.md:109-114; level 9 is routed to
        software by the session layer before reaching an engine).
        """
        from .. import native
        from ..engines import host_pool

        if cnv is None:
            cnv = self._cnv_default
        finals = list(final_flags) if final_flags is not None \
            else [True] * len(chunks)

        device_pack = os.environ.get("QZTPU_DEVICE_PACK", "auto")
        # auto: static sessions pack on device (closed-form codes, no
        # host tree build); dynamic sessions take the token path and pack
        # on the host
        use_device_pack = (device_pack == "1"
                           or (device_pack == "auto" and huffman_static))
        # both device packers shard over the dp mesh (rows and per-row
        # trees are independent; the dynamic host tree build sits between
        # two sharded passes)
        if (use_device_pack and algorithm == "deflate"
                and all(len(c) <= 65536 for c in chunks)):
            return self._compress_device_packed(chunks, finals, level, cnv,
                                                huffman_static)
        if (device_pack == "1" and algorithm == "lz4"
                and len(self.devices) == 1
                and all(len(c) <= 65536 for c in chunks)):
            return self._compress_lz4_device(chunks, cnv)

        # The device tokenizer's position field caps a row at 64 KiB;
        # sessions may use hw_buff_sz up to 512 KiB (params validation),
        # so oversized chunks are split into device rows and their block
        # payloads concatenated — non-final rows end with a sync flush,
        # so the joined payload is one valid raw stream per chunk.
        DEV_MAX = 65536
        if any(len(c) > DEV_MAX for c in chunks):
            return self._compress_split(chunks, finals, level, algorithm,
                                        mini_match, huffman_static, cnv,
                                        DEV_MAX)
        n = _pow2_chunk_n(chunks)

        results: List[Optional[Tuple[bytes, int]]] = [None] * len(chunks)
        mode = 1 if huffman_static else 0  # 0 = best(stored/static/dynamic)

        def pack_one(args):
            gi, chunk, row_toks, row_ntok, pre_crc = args
            if np.ndim(row_ntok) > 0:     # segment-compacted (nseg, k)
                from ..ops.lz77 import merge_segment_tokens
                toks = merge_segment_tokens(row_toks.ravel(), row_ntok,
                                            row_toks.shape[-1])
                ntok = len(toks)
            else:
                ntok = int(row_ntok)
                toks = row_toks[:ntok]
            if algorithm == "deflate":
                payload = native.lib.deflate_pack(chunk, toks, ntok,
                                                  final=finals[gi], mode=mode)
            elif algorithm == "lz4":
                payload = native.lib.lz4_pack(chunk, toks, ntok)
            else:  # lz4s
                payload = native.lib.lz4s_pack(chunk, toks, ntok, mini_match)
            if cnv:
                payload = self._verify_or_fallback(chunk, payload, algorithm,
                                                   finals[gi], level,
                                                   mini_match)
            crc = (pre_crc if pre_crc is not None
                   else zlib.crc32(chunk) & 0xFFFFFFFF)
            return gi, payload, crc

        pool = host_pool()
        futures = []
        for start, nt, toks, ntok, crcs in self._tokenize_tiles(
                chunks, n, algorithm, level):
            for i in range(nt):
                gi = start + i
                futures.append(pool.submit(
                    pack_one, (gi, chunks[gi], toks[i], ntok[i], crcs[i])))
        for f in futures:
            gi, payload, crc = f.result()
            results[gi] = (payload, crc)
        return results  # type: ignore[return-value]

    def _compress_device_packed(self, chunks, finals, level, cnv,
                                huffman_static=True):
        """Full-device deflate: tokenize AND entropy-pack on device; d2h
        carries final bitstream words (bucketed to the batch max). Static
        sessions use the fixed-code packer; dynamic sessions run the
        two-pass path (device histograms → host tree/header build
        (qz_dyn_plan) → device sort-merge lookup + pack). Host work per
        chunk: header/EOB OR-in, BFINAL flip / full-flush sync,
        stored-block guard on expansion, crc32."""
        import jax.numpy as jnp
        from ..ops.deflate_pack import (deflate_pack_device,
                                        deflate_pack_scan, finish_stream,
                                        deflate_analyze_hist,
                                        deflate_pack_dynamic,
                                        finish_stream_dynamic)
        from .. import native as _native

        dynamic = not huffman_static
        n = _pow2_chunk_n(chunks)
        ss, ov, _cs, ctx, probes = _tok_knobs(level, n)
        pkw = dict(search_seg=ss, search_overlap=ov, ctx_words=ctx,
                   probes=probes)

        ndev = len(self.devices)
        mesh = None
        if ndev > 1:
            from .mesh import make_mesh
            mesh = make_mesh(self.devices)

        starts = list(range(0, len(chunks), TILE_B))
        pending = []
        i = 0
        while i < len(starts):
            start = starts[i]
            # static path, single device: scan-group full tiles (see
            # SCAN_TILES — one dispatch covers K tiles)
            if (not dynamic and mesh is None and SCAN_TILES > 1
                    and len(chunks) - start >= 2 * TILE_B):
                grp = []
                while (len(grp) < SCAN_TILES and i + len(grp) < len(starts)
                       and len(chunks) - starts[i + len(grp)] >= TILE_B):
                    grp.append(starts[i + len(grp)])
                datas = np.zeros((len(grp), TILE_B, n), np.uint8)
                lens = np.zeros((len(grp), TILE_B), np.int32)
                for g, s in enumerate(grp):
                    datas[g], lens[g] = _stage_tile(
                        chunks[s:s + TILE_B], TILE_B, n)
                words, nbits = deflate_pack_scan(
                    jnp.asarray(datas), jnp.asarray(lens), n=n, **pkw)
                pending.append(("grp", grp, words, nbits))
                i += len(grp)
                continue
            tile = chunks[start:start + TILE_B]
            b = _bucket(len(tile))
            if mesh is not None and b % ndev:
                b = ((b + ndev - 1) // ndev) * ndev  # divisible batch
            data, lengths = _stage_tile(tile, b, n)
            i += 1
            if mesh is not None and not dynamic:
                from .mesh import mesh_pack_device
                words, nbits = mesh_pack_device(mesh, data, lengths, n=n,
                                                search_seg=ss,
                                                search_overlap=ov,
                                                ctx_words=ctx,
                                                probes=probes)
                pending.append((start, len(tile), words, nbits, None, None))
                continue
            if dynamic:
                # pass 1 with ONE tile of lookahead: tile k+1's analysis
                # overlaps tile k's host tree building, while at most two
                # tiles' dense planes live on device at a time (each
                # pending tile pins ~170MB of planes at TILE_B x 64K)
                if mesh is not None:
                    from .mesh import mesh_analyze_hist
                    hist, ml, dist, taken, lit = mesh_analyze_hist(
                        mesh, data, lengths, n=n, search_seg=ss,
                        search_overlap=ov, ctx_words=ctx, probes=probes)
                    dd = data          # pass 2 reshards the numpy batch
                else:
                    dd, ll = jnp.asarray(data), jnp.asarray(lengths)
                    hist, ml, dist, taken, lit = deflate_analyze_hist(
                        dd, ll, n=n, **pkw)
                pending.append((start, len(tile), "dyn1",
                                (dd, hist, ml, dist, taken, lit)))
                ready = [j for j, it in enumerate(pending)
                         if len(it) == 4 and isinstance(it[2], str)
                         and it[2] == "dyn1"]
                if len(ready) > 1:
                    self._dyn_pass2(pending, ready[0], n, mesh)
            else:
                dd, ll = jnp.asarray(data), jnp.asarray(lengths)
                words, nbits = deflate_pack_device(dd, ll, n=n, **pkw)
                pending.append((start, len(tile), words, nbits, None, None))

        # drain the remaining dynamic pass-1 tiles
        for idx, item in enumerate(pending):
            if (len(item) == 4 and isinstance(item[2], str)
                    and item[2] == "dyn1"):
                self._dyn_pass2(pending, idx, n, mesh)

        results: List[Optional[Tuple[bytes, int]]] = [None] * len(chunks)
        from ..engines import host_pool
        pool = host_pool()

        def finish_one(args):
            gi, words_row, bits, hdr, eob_pack = args
            chunk = chunks[gi]
            if hdr is not None:
                payload = finish_stream_dynamic(words_row, bits, hdr,
                                                eob_pack, final=finals[gi])
            else:
                payload = finish_stream(words_row, bits, final=finals[gi])
            # stored-block guard: never ship an expanded static stream
            # (the CnV-failure stored fallback, src/qatzip.c:1774-1806)
            if len(payload) >= len(chunk) + 8 and chunk:
                toks, rem = [], len(chunk)
                while rem:              # all-literal-run token cover
                    t = min(rem, 16383)
                    toks.append(0x40000000 | t)
                    rem -= t
                payload = _native.lib.deflate_pack(
                    chunk, np.asarray(toks, np.uint32), len(toks),
                    final=finals[gi], mode=0)
            if cnv:
                payload = self._verify_or_fallback(
                    chunk, payload, "deflate", finals[gi], level, 3)
            return gi, payload, zlib.crc32(chunk) & 0xFFFFFFFF

        futures = []
        for item in pending:
            if item[0] == "grp":
                # scan group: one bucketed d2h slice covers all K tiles
                _tag, grp, words_k, nbits_k = item
                nbits_np = np.asarray(nbits_k)           # (K, B)
                maxw = int(nbits_np.max() + 15 + 31) // 32 + 1 \
                    if nbits_np.size else 1
                k = _fetch_bucket(maxw, words_k.shape[2])
                words_np = np.asarray(words_k[:, :, :k])
                for g, s in enumerate(grp):
                    nt = min(TILE_B, len(chunks) - s)
                    for t in range(nt):
                        futures.append(pool.submit(
                            finish_one, (s + t, words_np[g][t],
                                         int(nbits_np[g][t]), None, 0)))
                continue
            start, nt, words, nbits, hdrs, packs = item
            nbits_np = np.asarray(nbits)
            # dynamic nbits excludes the <=15-bit EOB; pad the fetch
            maxw = int(nbits_np.max() + 15 + 31) // 32 + 1 if nt else 1
            k = _fetch_bucket(maxw, words.shape[1])
            words_np = np.asarray(words[:, :k])   # bucketed d2h slice
            for i in range(nt):
                hdr = hdrs[i] if hdrs is not None else None
                eob = int(packs[i][256]) if packs is not None else 0
                futures.append(pool.submit(
                    finish_one, (start + i, words_np[i], int(nbits_np[i]),
                                 hdr, eob)))
        for f in futures:
            gi, payload, crc = f.result()
            results[gi] = (payload, crc)
        return results  # type: ignore[return-value]

    def _dyn_pass2(self, pending, idx, n, mesh=None):
        """Dynamic device pack pass 2 for one pending tile: fetch its
        histograms, build trees/headers on the host (qz_dyn_plan), and
        dispatch the pack graph — releasing the tile's pass-1 planes.
        With a mesh, pass 2 shards over ``dp`` like pass 1 (trees are
        per-row operands)."""
        import jax.numpy as jnp
        from .. import native as _native
        from ..ops.deflate_pack import deflate_pack_dynamic

        start, nt, _tag, (dd, hist, ml, dist, taken, lit) = pending[idx]
        b = dd.shape[0]
        hist_np = np.asarray(hist)                # (b, 316) — tiny d2h
        packs = np.zeros((b, 286), np.uint16)
        dpacks = np.zeros((b, 30), np.uint16)
        hdrs = [b""] * b
        hbits = np.zeros(b, np.int32)
        for i in range(nt):
            lf = hist_np[i, :286].astype(np.uint32)
            lf[256] += 1                          # the EOB
            df = hist_np[i, 286:].astype(np.uint32)
            packs[i], dpacks[i], hdrs[i], hbits[i] = \
                _native.lib.dyn_plan(lf, df)
        if mesh is not None:
            from .mesh import mesh_pack_dynamic
            words, nbits = mesh_pack_dynamic(
                mesh, dd, ml, dist, taken, lit,
                packs.astype(np.uint32), dpacks.astype(np.uint32),
                hbits, n=n)
        else:
            words, nbits = deflate_pack_dynamic(
                dd, ml, dist, taken, lit,
                jnp.asarray(packs.astype(np.uint32)),
                jnp.asarray(dpacks.astype(np.uint32)),
                jnp.asarray(hbits), n=n)
        pending[idx] = (start, nt, words, nbits, hdrs, packs)

    def _compress_lz4_device(self, chunks, cnv):
        """Full-device LZ4 block packing (ops/lz4_pack.py). Chunks whose
        literal runs exceed the device packer's per-emission budget (ok
        flag false — incompressible-ish data) route to the host coder."""
        import jax.numpy as jnp
        from .. import native as _native
        from ..ops.lz4_pack import lz4_pack_device

        n = _pow2_chunk_n(chunks)

        pending = []
        for start in range(0, len(chunks), TILE_B):
            tile = chunks[start:start + TILE_B]
            b = _bucket(len(tile))
            data, lengths = _stage_tile(tile, b, n)
            words, nbytes, ok = lz4_pack_device(
                jnp.asarray(data), jnp.asarray(lengths), n=n)
            pending.append((start, len(tile), words, nbytes, ok))

        results: List[Optional[Tuple[bytes, int]]] = [None] * len(chunks)
        from ..engines import host_pool
        pool = host_pool()

        def finish_one(args):
            gi, words_row, nb, row_ok = args
            chunk = chunks[gi]
            if row_ok and chunk:
                payload = words_row[: (nb + 3) // 4].tobytes()[:nb]
            else:
                # long-literal-run or empty chunk — host coder
                payload = _native.lib.lz4_compress_block(chunk)
            if cnv:
                try:
                    out = _native.lib.lz4_decompress_block(payload,
                                                           len(chunk))
                    if out != chunk:
                        raise ValueError
                except Exception:  # noqa: BLE001
                    payload = _native.lib.lz4_compress_block(chunk)
            return gi, payload, zlib.crc32(chunk) & 0xFFFFFFFF

        futures = []
        for start, nt, words, nbytes, ok in pending:
            nb_np = np.asarray(nbytes)
            ok_np = np.asarray(ok)
            maxw = int(nb_np.max() + 3) // 4 + 1 if nt else 1
            k = _fetch_bucket(maxw, words.shape[1])
            words_np = np.asarray(words[:, :k])
            for i in range(nt):
                futures.append(pool.submit(
                    finish_one, (start + i, words_np[i], int(nb_np[i]),
                                 bool(ok_np[i]))))
        for f in futures:
            gi, payload, crc = f.result()
            results[gi] = (payload, crc)
        return results  # type: ignore[return-value]

    def _compress_split(self, chunks, finals, level, algorithm, mini_match,
                        huffman_static, cnv, dev_max):
        """Oversized-chunk path: split each chunk into <=64 KiB device
        rows, compress the rows (recursively via the normal path, with
        per-row final flags), and join each chunk's row payloads."""
        if algorithm != "deflate":
            # LZ4/LZ4s blocks can't be formed by concatenating sub-block
            # payloads; the host block coder handles any size directly
            # (the dispatch layer clamps LZ4 chunks to 64 KiB anyway)
            from ..engines import host_engine
            return host_engine.compress_chunks(
                chunks, level=level, algorithm=algorithm,
                final_flags=finals, mini_match=mini_match,
                huffman_static=huffman_static)
        units = []                  # flattened rows across all chunks
        unit_finals = []
        spans = []                  # (unit_start, unit_count) per chunk
        for gi, c in enumerate(chunks):
            start = len(units)
            pieces = [c[o:o + dev_max] for o in range(0, len(c), dev_max)] \
                or [b""]
            for k, p in enumerate(pieces):
                units.append(p)
                unit_finals.append(finals[gi] if k == len(pieces) - 1
                                   else False)
            spans.append((start, len(pieces)))
        unit_results = self.compress_chunks(
            units, level=level, algorithm=algorithm,
            final_flags=unit_finals, mini_match=mini_match,
            huffman_static=huffman_static, cnv=False)
        out = []
        for gi, c in enumerate(chunks):
            start, cnt = spans[gi]
            payload = b"".join(unit_results[start + k][0]
                               for k in range(cnt))
            if cnv:
                payload = self._verify_or_fallback(
                    c, payload, algorithm, finals[gi], level, mini_match)
            out.append((payload, zlib.crc32(c) & 0xFFFFFFFF))
        return out

    def _verify_or_fallback(self, chunk: bytes, payload: bytes,
                            algorithm: str, final: bool, level: int,
                            mini_match: int) -> bytes:
        """CnV: decode-verify; on mismatch re-encode with the SW codec
        (reference: CnV error → stored-block fallback,
        src/qatzip.c:1774-1806)."""
        from .. import native
        try:
            if algorithm == "deflate":
                out = zlib.decompressobj(-15).decompress(payload)
            elif algorithm == "lz4":
                out = native.lib.lz4_decompress_block(payload, len(chunk))
            else:
                return payload  # lz4s verified via its consumer
            if out == chunk:
                return payload
        except Exception:  # noqa: BLE001
            pass
        qz_log("CnV mismatch — software fallback for %d-byte chunk",
               len(chunk))
        from ..engines import host_engine
        # force the zlib coder: the fallback must be INDEPENDENT of the
        # native packer whose output just failed verification
        (fb, _), = host_engine.compress_chunks(
            [chunk], level=level, algorithm=algorithm,
            final_flags=[final], mini_match=mini_match, sw_coder="zlib")
        return fb

    def decompress_chunks(self, payloads: Sequence[bytes],
                          expected_sizes: Sequence[int], *,
                          algorithm: str = "deflate") -> List[bytes]:
        """Decompress router — the isQATProcessable analog in reverse.

        A device leg exists for LZ4 (host ref-plane parse + device
        pointer-doubling chain resolution, ops/lz4_decode.py) and is
        selected with QZTPU_DEVICE_DECODE=1. The default routes members to
        the host pool (batched GIL-free native inflate/LZ4); routing to
        the faster engine is how the reference treats its own SW path
        (src/qatzip.c:2886-2899). Which leg is faster on the GPU is not
        measured yet.
        """
        if (algorithm == "lz4"
                and os.environ.get("QZTPU_DEVICE_DECODE", "0") == "1"):
            from ..ops.lz4_decode import decode_blocks_device
            try:
                return decode_blocks_device(payloads, expected_sizes)
            except (ValueError, RuntimeError):
                pass  # malformed or no native parser — host pool decides
        from ..engines import host_engine
        return host_engine.decompress_chunks(payloads, expected_sizes,
                                             algorithm=algorithm)


def build_engine(algorithm: str, devices):
    """Factory used by the runtime engine pool (runtime.get_engine)."""
    if not devices:
        return None
    return DeviceEngine(devices, algorithm)
