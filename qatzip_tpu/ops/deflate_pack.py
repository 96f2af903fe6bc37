"""On-device DEFLATE entropy packing (static and dynamic Huffman).

The round-1 pipeline tokenized on device and entropy-packed on the host
(csrc qz_deflate_pack, ~200 MB/s/core) — device→host carried token
streams.  This module emits the FINAL deflate bitstream on device, so d2h
carries compressed words and the host only frames members (the analog of
the QAT silicon's single-call compress returning compressed bytes,
src/qatzip.c:1445).

Shape of the problem (no serial bit cursor):

  1. emission planes — every position p emits its static-Huffman bits:
     a taken match emits len/dist codes + extra bits (<=31 bits, pure
     arithmetic: static codes have closed forms, no table gathers); a
     literal emits its 8/9-bit code; covered positions emit nothing.
  2. bit offsets — one exclusive cumsum of per-position bit counts.
  3. group pack — positions are grouped (G=256); each group OR-packs its
     emissions into a (W=74)-word window at the group's global word base
     via compare-select masks (dense vector ops, zero gathers).
  4. assembly — one scatter-add places every group window at its word
     offset; contributions to a shared straddle word have disjoint bits,
     so integer add == bitwise or (on a GPU an atomic add per word).

The stream starts with the 3-bit block header (BFINAL=0, BTYPE=static);
the end-of-block symbol is the static 7-bit all-zeros code, so EOB and
byte padding are pure bit-count accounting (zeros are already there).
The host flips BFINAL for final chunks and appends the empty-stored-block
sync (00 00 FF FF) for non-final chunks — exactly zlib's Z_FULL_FLUSH.

The DYNAMIC path (deflate_analyze_hist + qz_dyn_plan + deflate_pack_
dynamic) keeps per-chunk optimal Huffman coding on device: pass 1 emits
per-chunk symbol histograms (fused compare-reduce), the host builds both
length-limited-12 trees and the block header (tiny), and pass 2 resolves
per-position codes with a sort-merge (lit/len, 286 entries) and a fused
compare-select (distance, 30 entries), splitting each match emission
across two covered positions so everything fits 32-bit words. Ratio is
at parity with the host dynamic packer (1.075x vs 1.084x zlib L1 on the
mixed corpus; static is 46% worse there — DNA/structured data).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .lz77 import _analyze


GROUP = 256          # positions per pack group
# worst case bits per group: 256 literals x 9 bits = 2304, plus a 31-bit
# start straddle -> 73 words; +1 guard
GROUP_W = 74
HDR_BITS = 3         # BFINAL + BTYPE(01), emitted as 0b010 (BFINAL=0)
EOB_BITS = 7         # static end-of-block code is seven 0 bits


def _rev16(x, nbits):
    """Bit-reverse the low ``nbits`` of x (<=16)."""
    x = x.astype(jnp.uint32)
    x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555)
    x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333)
    x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F)
    x = ((x & 0x00FF) << 8) | ((x >> 8) & 0x00FF)
    return x >> (16 - nbits)


def _bitlen(x, maxbits: int):
    """floor(log2(x))+1 for x >= 1, else 0 — via the f32 exponent field
    (exact for x < 2^24; callers pass x <= 32768). One convert + shift
    instead of a ``maxbits``-deep compare-add chain."""
    assert maxbits <= 24
    f = x.astype(jnp.float32)
    e = (jax.lax.bitcast_convert_type(f, jnp.int32) >> 23) & 0xFF
    return jnp.where(x >= 1, e - 126, 0).astype(x.dtype)


def _match_emission(ml, dist):
    """Static-Huffman bits for a match: (value LSB-first, nbits).

    Length symbol (RFC1951 3.2.5): lc = ml-3; lc<8 -> sym 257+lc;
    ml==258 -> 285; else e = bitlen(lc)-3, sym = 257+4*(e+1)+((lc>>e)&3),
    extra = lc & (2^e - 1). Static code: syms 256-279 are 7 bits (sym-256),
    280-287 are 8 bits (0xC0+sym-280).
    Distance: d1 = dist-1; d1<4 -> code d1; else e = bitlen(d1)-2,
    code = 2*(e+1)+((d1>>e)&1), extra = d1 & (2^e - 1); 5-bit fixed code.
    """
    lc = ml - 3
    e_len = jnp.maximum(_bitlen(jnp.maximum(lc, 1), 8) - 3, 0)
    sym_hi = 257 + 4 * (e_len + 1) + ((lc >> e_len) & 3)
    lsym = jnp.where(lc < 8, 257 + lc, jnp.where(ml == 258, 285, sym_hi))
    e_len = jnp.where((lc < 8) | (ml == 258), 0, e_len)
    lextra = lc & ((1 << e_len) - 1)
    lcode_7 = lsym - 256
    lcode_8 = 0xC0 + lsym - 280
    lbits = jnp.where(lsym < 280, 7, 8)
    lcode = jnp.where(lsym < 280, _rev16(lcode_7, 7), _rev16(lcode_8, 8))

    d1 = dist - 1
    e_d = jnp.maximum(_bitlen(jnp.maximum(d1, 1), 16) - 2, 0)
    dcode_hi = 2 * (e_d + 1) + ((d1 >> e_d) & 1)
    dcode = jnp.where(d1 < 4, d1, dcode_hi)
    e_d = jnp.where(d1 < 4, 0, e_d)
    dextra = d1 & ((1 << e_d) - 1)
    dcode_r = _rev16(dcode, 5)

    v = lcode.astype(jnp.uint32)
    sh = lbits
    v = v | (lextra.astype(jnp.uint32) << sh)
    sh = sh + e_len
    v = v | (dcode_r << sh)
    sh = sh + 5
    v = v | (dextra.astype(jnp.uint32) << sh)
    nbits = sh + e_d
    return v, nbits.astype(jnp.int32)


def _lit_emission(byte):
    """Static literal code: 0-143 -> 8 bits 0x30+b; 144-255 -> 9 bits
    0x190+(b-144)."""
    b32 = byte.astype(jnp.int32)
    hi = b32 >= 144
    code = jnp.where(hi, 0x190 + b32 - 144, 0x30 + b32)
    nbits = jnp.where(hi, 9, 8)
    v = jnp.where(hi, _rev16(code, 9), _rev16(code, 8))
    return v.astype(jnp.uint32), nbits.astype(jnp.int32)


PACK_UNROLL = 32   # positions per fori body


@functools.partial(jax.jit, static_argnames=("n", "parse_seg", "ctx_words",
                                             "probes", "max_words",
                                             "search_seg",
                                             "search_overlap"))
def deflate_pack_device(data: jnp.ndarray, lengths: jnp.ndarray, *, n: int,
                        parse_seg: int = 8192, ctx_words: int = 4,
                        probes: int = 6, max_words: int = 0,
                        search_seg: int = 0, search_overlap: int = 1024,
                        ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Compress a chunk batch to final static-Huffman deflate bitstreams.

    Returns:
      words: (B, max_words) uint32 little-endian bitstream words per row
             (header bit 0 = BFINAL is left 0; EOB's 7 zero bits and byte
             padding are implicit zeros).
      nbits: (B,) int32 total bits per row INCLUDING header and EOB.
    """
    b = data.shape[0]
    if max_words == 0:
        max_words = (n * 9 + HDR_BITS + EOB_BITS + 31) // 32 + 2
    iota, ml, dist, taken, lit, valid = _analyze(
        data, lengths, n=n, min_match=4, max_match=258, window=32768,
        parse_seg=parse_seg, ctx_words=ctx_words, probes=probes,
        search_seg=search_seg, search_overlap=search_overlap)

    mv, mn = _match_emission(ml, dist)
    lv, ln = _lit_emission(data)
    bits = jnp.where(taken, mv, jnp.where(lit, lv, jnp.uint32(0)))
    nbits = jnp.where(taken, mn, jnp.where(lit, ln, 0))

    # global bit offset of each position's emission (header occupies [0,3))
    csum = jnp.cumsum(nbits, axis=1, dtype=jnp.int32)
    off = HDR_BITS + csum - nbits               # exclusive prefix
    total_bits = HDR_BITS + csum[:, -1] + EOB_BITS

    out = _group_pack_assemble(bits, nbits, off, b, n, max_words,
                               group_w=GROUP_W)
    # block header bits [0,3): BFINAL=0, BTYPE=01 -> LSB-first 0b010;
    # emissions start at bit 3, so the add is an or
    out = out.at[:, 0].add(jnp.uint32(0b010))
    return out, total_bits.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("n", "parse_seg", "ctx_words",
                                             "probes", "search_seg",
                                             "search_overlap"))
def deflate_pack_scan(data: jnp.ndarray, lengths: jnp.ndarray, *, n: int,
                      parse_seg: int = 8192, ctx_words: int = 4,
                      probes: int = 6, search_seg: int = 0,
                      search_overlap: int = 1024,
                      ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """K tiles of the static device pack in ONE dispatch via lax.scan —
    data (K, B, n), lengths (K, B); stacked outputs of
    :func:`deflate_pack_device`. Same deeper-submission-ring rationale
    as ops/lz77.lz77_tokenize_scan."""
    def body(carry, xs):
        d, l = xs
        words, nbits = deflate_pack_device(
            d, l, n=n, parse_seg=parse_seg, ctx_words=ctx_words,
            probes=probes, max_words=0, search_seg=search_seg,
            search_overlap=search_overlap)
        return carry, (words, nbits)

    _, (words, nbits) = jax.lax.scan(body, jnp.int32(0), (data, lengths))
    return words, nbits


def _group_pack_assemble(bits, nbits, off, b: int, n: int, max_words: int,
                         group_w: int = GROUP_W):
    """Group-window OR-pack + assembly (shared by the static and dynamic
    device packers). Emissions must be <= 32 bits; ``group_w`` bounds a
    group's worst-case word span (74 for static's <=9-bit literals,
    DYN_GROUP_W for limit-12 dynamic codes)."""
    ngroups = n // GROUP
    rows = b * ngroups
    # bits MUST be unsigned: a full-32-bit emission sets bit 31, and an
    # int32 arithmetic right shift would sign-extend garbage into the
    # straddle word (hit with dist >= 16385 + long length codes)
    bits = bits.astype(jnp.uint32)
    s = (off & 31).astype(jnp.uint32)
    lo = bits << s
    hi = (bits >> 1) >> (31 - s)                # safe for s == 0
    word = off >> 5
    gbase = word.reshape(rows, GROUP)[:, 0:1]   # word base: first position's
    # offset word — NOT necessarily the group's first EMITTED word, but
    # off is monotone so word >= gbase always
    widx = word.reshape(rows, GROUP) - gbase    # (rows, GROUP) in [0, W)
    lo_r = lo.reshape(rows, GROUP)
    hi_r = hi.reshape(rows, GROUP)
    nz = (nbits > 0).reshape(rows, GROUP)

    w_iota = jax.lax.broadcasted_iota(jnp.int32, (rows, group_w), 1)

    def pack_body(i, buf):
        out = buf
        for u in range(PACK_UNROLL):
            j = i * PACK_UNROLL + u
            wj = jax.lax.dynamic_slice(widx, (0, j), (rows, 1))
            loj = jax.lax.dynamic_slice(lo_r, (0, j), (rows, 1))
            hij = jax.lax.dynamic_slice(hi_r, (0, j), (rows, 1))
            nzj = jax.lax.dynamic_slice(nz, (0, j), (rows, 1))
            zero = jnp.zeros((), jnp.uint32)
            contrib = (jnp.where((w_iota == wj) & nzj, loj, zero)
                       | jnp.where((w_iota == wj + 1) & nzj, hij, zero))
            out = out | contrib.astype(jnp.uint32)
        return out

    buf0 = jnp.zeros((rows, group_w), jnp.uint32)
    grp = jax.lax.fori_loop(0, GROUP // PACK_UNROLL, pack_body, buf0)

    # --- assembly: place all group windows at their word offsets ----------
    # contributions to a shared straddle word carry disjoint bits, so
    # integer add == bitwise or
    grp = grp.reshape(b, ngroups, group_w)
    wo = gbase.reshape(b, ngroups)              # word offset per group
    out = jnp.zeros((b, max_words), jnp.uint32)
    widx_full = wo[:, :, None] + jnp.arange(group_w, dtype=jnp.int32)[None,
                                                                      None, :]
    return out.at[jnp.arange(b)[:, None, None], widx_full].add(
        grp, mode="drop")


# ---------------------------------------------------------------------------
# Dynamic Huffman, two device passes (the ratio-parity device pack).
#
# Static Huffman costs ~46% ratio on mixed corpora (DNA/structured data
# want short literal codes). The dynamic path keeps entropy coding on
# device: pass 1 computes per-chunk symbol histograms (fused
# compare-reduce, no gathers); the host builds BOTH optimal
# length-limited-12 trees and the block-header bitstream (qz_dyn_plan);
# pass 2 resolves per-position codes — a SORT-MERGE for the 286-entry
# lit/len table (no per-row table gathers) and a fused compare-select for the 30-entry distance
# table. Each match emits its LENGTH part at p and its DISTANCE part at
# p+1 (always covered, min match 4), so every emission fits one u32 word
# even with 12-bit codes.
# ---------------------------------------------------------------------------

DYN_LIMIT = 12     # code-length limit for both trees
# Match emissions are SPLIT across two covered positions so each part
# fits a 32-bit word with limit-12 codes: the length part (code<=12 +
# extra<=5) at p, the distance part (code<=12 + extra<=13) at p+1 — a
# match covers >=4 positions, so p+1 never emits anything else.
DYN_GROUP_W = (GROUP * DYN_LIMIT + 31) // 32 + 3   # all-lit worst + straddle


def _len_symbol(ml):
    """Match length -> (length symbol 257..285, extra bits, extra value)."""
    lc = ml - 3
    e_len = jnp.maximum(_bitlen(jnp.maximum(lc, 1), 8) - 3, 0)
    sym_hi = 257 + 4 * (e_len + 1) + ((lc >> e_len) & 3)
    lsym = jnp.where(lc < 8, 257 + lc, jnp.where(ml == 258, 285, sym_hi))
    e_len = jnp.where((lc < 8) | (ml == 258), 0, e_len)
    lextra = lc & ((1 << e_len) - 1)
    return lsym, e_len, lextra


def _dist_symbol(dist):
    """Distance -> (dist symbol 0..29, extra bits, extra value)."""
    d1 = dist - 1
    e_d = jnp.maximum(_bitlen(jnp.maximum(d1, 1), 16) - 2, 0)
    dsym_hi = 2 * (e_d + 1) + ((d1 >> e_d) & 1)
    dsym = jnp.where(d1 < 4, d1, dsym_hi)
    e_d = jnp.where(d1 < 4, 0, e_d)
    dextra = d1 & ((1 << e_d) - 1)
    return dsym, e_d, dextra


@functools.partial(jax.jit, static_argnames=("n", "parse_seg", "ctx_words",
                                             "probes", "search_seg",
                                             "search_overlap"))
def deflate_analyze_hist(data: jnp.ndarray, lengths: jnp.ndarray, *, n: int,
                         parse_seg: int = 8192, ctx_words: int = 4,
                         probes: int = 6, search_seg: int = 0,
                         search_overlap: int = 1024):
    """Pass 1: parse + per-chunk symbol histogram (B, 316): lit/len
    symbols 0..285 followed by distance symbols 286..315 — both trees are
    built per chunk on the host from this (qz_dyn_plan)."""
    iota, ml, dist, taken, lit, valid = _analyze(
        data, lengths, n=n, min_match=4, max_match=258, window=32768,
        parse_seg=parse_seg, ctx_words=ctx_words, probes=probes,
        search_seg=search_seg, search_overlap=search_overlap)
    lsym, _e, _x = _len_symbol(ml)
    dsym, _ed, _dx = _dist_symbol(dist)
    sym = jnp.where(taken, lsym,
                    jnp.where(lit, data.astype(jnp.int32), 320))
    dsym_m = jnp.where(taken, 286 + dsym, 320)
    hist_parts = []
    for s0 in range(0, 320, 32):   # fused compare-reduce strips
        strip = jnp.arange(s0, s0 + 32, dtype=jnp.int32)
        hist_parts.append(jnp.sum(
            (sym[:, :, None] == strip[None, None, :]).astype(jnp.int32)
            + (dsym_m[:, :, None] == strip[None, None, :]).astype(jnp.int32),
            axis=1))
    hist = jnp.concatenate(hist_parts, axis=1)[:, :316]
    return hist, ml, dist, taken, lit


@functools.partial(jax.jit, static_argnames=("n", "max_words"))
def deflate_pack_dynamic(data: jnp.ndarray, ml, dist, taken, lit,
                         lit_pack: jnp.ndarray, dist_pack: jnp.ndarray,
                         hdr_bits: jnp.ndarray, *,
                         n: int, max_words: int = 0):
    """Pass 2: per-position code lookup + bit-pack with per-chunk trees.

    lit_pack: (B, 286) and dist_pack: (B, 30) uint32, each bit-reversed
    code | len<<12 (qz_dyn_plan, both trees optimal length-limited-12).
    The lit/len lookup rides a sort-merge (merge the 286 table entries
    with the symbol stream by key, forward-fill, unsort); the 30-entry
    distance table is a cheap fused compare-select. A match emits its
    length part at p and its distance part at p+1 (covered), so every
    emission fits one u32 word. hdr_bits: per-chunk header bit length —
    emissions start there; the host ORs the header bytes in afterwards
    (the reserved prefix is zero on device). Returns (words, nbits
    WITHOUT the EOB — the host appends the per-chunk EOB code).
    """
    b = data.shape[0]
    if max_words == 0:
        max_words = (n * DYN_LIMIT + 4096 + 31) // 32 + 2
    lsym, e_len, lextra = _len_symbol(ml)
    sym = jnp.where(taken, lsym,
                    jnp.where(lit, data.astype(jnp.int32), 286))
    dsym, e_d, dextra = _dist_symbol(dist)

    # --- sort-merge lit/len table lookup ------------------------------
    # entries: key = sym*2, value = table pack; queries: key =
    # sym*2+1, value = original position (for the unsort)
    iota_n = jax.lax.broadcasted_iota(jnp.uint32, (b, n), 1)
    ent_key = jnp.broadcast_to(
        (jnp.arange(286, dtype=jnp.uint32) * 2)[None, :], (b, 286))
    q_key = sym.astype(jnp.uint32) * 2 + 1
    keys = jnp.concatenate([ent_key, q_key], axis=1)
    vals = jnp.concatenate([lit_pack.astype(jnp.uint32), iota_n], axis=1)
    # unstable: tied keys are only duplicate queries with one symbol,
    # and the cummax forward-fill is order-independent among them
    keys_s, vals_s = jax.lax.sort((keys, vals), dimension=1, num_keys=1,
                                  is_stable=False)
    is_ent = (keys_s & 1) == 0
    # forward-fill: packed (sym<<16 | table_pack) is monotone in sym
    fill_src = jnp.where(is_ent, ((keys_s >> 1) << 16) | vals_s, 0)
    filled = jax.lax.cummax(fill_src, axis=1)
    # unsort queries back to position order
    big = jnp.uint32(1 << 20)
    key2 = jnp.where(is_ent, big + (keys_s >> 1), vals_s)
    _, pack_by_pos = jax.lax.sort(
        (key2, filled & jnp.uint32(0xFFFF)), dimension=1, num_keys=1,
        is_stable=False)                      # key2 unique
    pack_by_pos = pack_by_pos[:, :n]

    # --- distance table: fused compare-select over 30 entries ---------
    dpack = jnp.zeros((b, n), jnp.uint32)
    for k in range(30):
        dpack = dpack | jnp.where(dsym == k, dist_pack[:, k:k + 1], 0)

    code = pack_by_pos & 0xFFF
    clen = (pack_by_pos >> 12).astype(jnp.int32)
    dcode = dpack & 0xFFF
    dclen = (dpack >> 12).astype(jnp.int32)

    # --- split emissions: length part at p, distance part at p+1 ----------
    len_bits = code | (lextra.astype(jnp.uint32) << clen)
    len_nbits = clen + e_len
    dist_bits = dcode | (dextra.astype(jnp.uint32) << dclen)
    dist_nbits = dclen + e_d
    # shift the distance part to p+1 (always covered: min match is 4)
    zc1 = jnp.zeros((b, 1), jnp.uint32)
    zi1 = jnp.zeros((b, 1), jnp.int32)
    dp_bits = jnp.concatenate([zc1, dist_bits[:, :-1]], axis=1)
    dp_nbits = jnp.concatenate([zi1, dist_nbits[:, :-1]], axis=1)
    dp_mask = jnp.concatenate([jnp.zeros((b, 1), bool), taken[:, :-1]],
                              axis=1)

    bits = jnp.where(taken, len_bits,
                     jnp.where(dp_mask, dp_bits,
                               jnp.where(lit, code, jnp.uint32(0))))
    nbits = jnp.where(taken, len_nbits,
                      jnp.where(dp_mask, dp_nbits,
                                jnp.where(lit, clen, 0)))

    csum = jnp.cumsum(nbits, axis=1, dtype=jnp.int32)
    off = hdr_bits[:, None] + csum - nbits
    total_bits = hdr_bits + csum[:, -1]        # EOB appended by host

    out = _group_pack_assemble(bits, nbits, off, b, n, max_words,
                               group_w=DYN_GROUP_W)
    return out, total_bits.astype(jnp.int32)


# ---------------------------------------------------------------------------
# Host-side framing helpers
# ---------------------------------------------------------------------------

def finish_stream_dynamic(words_row: np.ndarray, nbits: int,
                          hdr_bytes: bytes, eob_pack: int,
                          final: bool) -> bytes:
    """Dynamic-path framing: OR the host-built header into the reserved
    zero prefix, append the (dynamic) EOB code at bit ``nbits``, then
    finalize like the static path."""
    eob_code = eob_pack & 0xFFF
    eob_len = eob_pack >> 12
    total = nbits + eob_len
    nbytes = (total + 7) // 8
    buf = bytearray(words_row[: (nbytes + 3) // 4].tobytes()[:nbytes])
    if len(buf) < nbytes:
        buf.extend(b"\0" * (nbytes - len(buf)))
    for i, hb in enumerate(hdr_bytes):      # header prefix is zeros on dev
        buf[i] |= hb
    # OR the EOB code at bit offset nbits
    v = eob_code << (nbits & 7)
    pos = nbits >> 3
    while v:
        if pos >= len(buf):
            buf.append(0)
        buf[pos] |= v & 0xFF
        v >>= 8
        pos += 1
    if final:
        buf[0] |= 0x01
        return bytes(buf)
    nb2 = (total + 3 + 7) // 8       # 3-bit stored header, pad to byte
    while len(buf) < nb2:
        buf.append(0)
    return bytes(buf) + b"\x00\x00\xff\xff"


def finish_stream(words_row: np.ndarray, nbits: int, final: bool) -> bytes:
    """Turn one row's device words into a raw deflate byte stream.

    final=True: set BFINAL, zero-pad to a byte (the stream ends).
    final=False: append zlib-style Z_FULL_FLUSH — an empty stored block
    (3 zero header bits, pad to byte, then LEN/NLEN = 00 00 FF FF) so the
    next chunk's stream can be byte-concatenated.
    """
    nbytes = (nbits + 7) // 8
    buf = bytearray(words_row[: (nbytes + 3) // 4].tobytes()[:nbytes])
    if not buf:
        buf = bytearray(1)
    if final:
        buf[0] |= 0x01
        return bytes(buf)
    # non-final: empty stored block for byte alignment (full flush)
    nb2 = (nbits + 3 + 7) // 8          # 3-bit stored header, then pad
    while len(buf) < nb2:
        buf.append(0)
    return bytes(buf) + b"\x00\x00\xff\xff"
