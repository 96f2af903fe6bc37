"""Batched LZ77 match finding + greedy parse on the device (XLA-native).

This is the accelerated analog of the reference's hardware compression
pipeline (doCompressIn/doCompressOut, src/qatzip.c:1336-1887): a request is
fanned into ``hw_buff_sz`` chunks, the whole batch is tokenized on device,
and the host stitches the ordered results into framed members.

No translation of the C hash-chain loop (a scalar serial loop per chunk).
Every stage is a dense vector op over the full (batch, chunk) plane:

  1. word packing      — context words at each position, pure shifts
  2. hashing           — multiplicative hash of the 4-byte word
  3. candidate search  — the k most-recent previous occurrences per hash
                         via ONE stable sort of (hash<<16|pos) that carries
                         16 bytes of context; bucket predecessors are plain
                         shifts in the sorted domain, and match lengths
                         come from comparing the carried context — replaces
                         the serial hash-chain of the reference (QAT
                         silicon / zlib) with zero gathers
  4. un-sort           — a second (permutation) sort keyed on position
  5. long matches      — saturation doubling over static shifts
                         (16→32→…→max_match), plus lazy-matching demotion
  6. parse             — a column-lockstep greedy-parse scan over segment
                         lanes (one reach scalar per lane, zero gathers)
  7. compaction        — one 2-operand sort moves emitted tokens to each
                         row's prefix in position order

Output tokens are packed uint32:
  match:        bit31=1, match length in bits [16,31), (dist-1) in [0,16)
  literal run:  bit31=0, bit30=1, run length in bits [0,14) — the run's
                bytes are read from the source at the token's running
                position (consumers track position)
  literal byte: bit31=0, bit30=0, byte in bits [0,8) (legacy single)

The host-side entropy stage (Huffman bit-packing / LZ4 byte emit) consumes
these tokens; see csrc/qztpu_native.cpp and parallel/dispatch.py.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.jaxcache import ensure_compile_cache

ensure_compile_cache()

HASH_BITS = 15
HASH_MUL = np.uint32(2654435761)

TOK_MATCH_BIT = np.uint32(0x80000000)
TOK_LITRUN_BIT = np.uint32(0x40000000)
LITRUN_MAX = 16383
# Absolute run-token split boundary (power of two). Splitting runs does
# NOT change the emitted bitstream (packers walk positions; k run tokens
# emit the same literal codes as one) — it only bounds the doubling-round
# count of the run-length plane, so smaller is faster until the extra
# token d2h shows up.
RUN_SPLIT = 2048


def _word4(data_pad: jnp.ndarray, n: int) -> jnp.ndarray:
    """w4[:, i] = little-endian uint32 of bytes i..i+3 (data padded by >=3)."""
    d = data_pad.astype(jnp.uint32)
    return (d[:, 0:n]
            | (d[:, 1:n + 1] << 8)
            | (d[:, 2:n + 2] << 16)
            | (d[:, 3:n + 3] << 24))


CTX_WORDS = 4          # 16 bytes of match context carried through the sort
CTX_BYTES = CTX_WORDS * 4


def _shl(x: jnp.ndarray, k: int, fill):
    """x shifted left by k along axis 1 (x[i] -> x[i+k]), padded with fill."""
    b, n = x.shape
    if k >= n:
        return jnp.full((b, n), fill, x.dtype)
    return jnp.concatenate(
        [x[:, k:], jnp.full((b, k), fill, x.dtype)], axis=1)


# All lax.sort calls below pass is_stable=False: every sort key carries
# the element's position in its low bits, so keys are UNIQUE per row and
# an unstable sort is deterministic (and cheaper than a stable one).
PARSE_UNROLL = 128


def _parse_scan(is_match, ml, seg: int, nseg: int, b: int):
    """Greedy-parse coverage scan — pure column ops, zero gathers.

    Replaces a token walk (one take_along_axis per emitted token). The
    greedy parse is a
    1-state recurrence per lane — ``reach`` = end of the active match —
    advanced one column at a time in lockstep over (b*nseg) independent
    segment lanes. Each column touch is a static slice, so the whole scan
    is seg/UNROLL fused loop iterations of (rows,) vector ops.

    Returns dense (b, n) planes: ``taken`` (match emitted at p) and
    ``lit`` (p emits its own literal).  Positions inside a taken match are
    neither.  Also the coverage source for the on-device bit-packer.
    """
    rows = b * nseg
    im = is_match.reshape(rows, seg)
    mls = ml.reshape(rows, seg)
    U = PARSE_UNROLL
    while seg % U:           # small parse segments: drop to a divisor
        U //= 2

    def body(i, state):
        reach, taken, lit = state
        base = i * U
        im_blk = jax.lax.dynamic_slice(im, (0, base), (rows, U))
        ml_blk = jax.lax.dynamic_slice(mls, (0, base), (rows, U))
        t_cols, l_cols = [], []
        for u in range(U):
            p = base + u
            free = p >= reach
            tk = free & im_blk[:, u]
            lt = free & ~im_blk[:, u]
            reach = jnp.where(tk, p + ml_blk[:, u], reach)
            t_cols.append(tk)
            l_cols.append(lt)
        taken = jax.lax.dynamic_update_slice(
            taken, jnp.stack(t_cols, axis=1), (0, base))
        lit = jax.lax.dynamic_update_slice(
            lit, jnp.stack(l_cols, axis=1), (0, base))
        return reach, taken, lit

    reach0 = jnp.zeros((rows,), jnp.int32)
    taken0 = jnp.zeros((rows, seg), bool)
    lit0 = jnp.zeros((rows, seg), bool)
    _, taken, lit = jax.lax.fori_loop(0, seg // U, body,
                                      (reach0, taken0, lit0))
    n = seg * nseg
    return taken.reshape(b, n), lit.reshape(b, n)


def _analyze(data, lengths, *, n, min_match, max_match, window,
             parse_seg, ctx_words, probes, lz4_rules: bool = False,
             search_seg: int = 0, search_overlap: int = 1024,
             search_stride: int = 1):
    """Match finding + greedy parse — the shared device analysis stages.

    Returns dense (B, n) planes: iota, ml, dist, taken (match emitted at
    p), lit (p emits a literal), valid (p < row length). Consumed by the
    token path (lz77_tokenize) and the on-device entropy packers
    (ops/deflate_pack.py, ops/lz4_pack.py).

    ``lz4_rules`` applies the LZ4 block end rules before the parse (last
    5 bytes literal, no match starting within the last 12 — the demotions
    qz_lz4_pack does at the token level, csrc).

    ``search_seg`` (0 = whole row) segments the CANDIDATE SEARCH: the
    sort/unsort pair runs over windows of WIDTH ``search_seg`` at stride
    ``search_seg - search_overlap`` instead of the full (B, n) rows,
    because XLA sort cost grows with row length (the bitonic depth).
    Keep ``search_seg`` a POWER OF TWO: XLA pads the sort dimension up to
    one, which is why the window is W wide with the overlap INSIDE it
    rather than W+ov wide. Candidates are
    window-local: each window owns its last W-ov positions and the exact
    back-reference reach at owned offset x is ``search_overlap + x`` (so
    never less than the overlap — plain non-overlapped segmentation
    loses 2.3x ratio on stride-record data from the per-segment cold
    restarts). A ratio/speed knob priced by tools/ratiocheck.py.
    """
    assert n <= 65536, "position field is 16 bits"
    ctx_bytes = ctx_words * 4
    b = data.shape[0]
    lengths = lengths.astype(jnp.int32)
    pad = jnp.zeros((b, ctx_bytes + 8), jnp.uint8)
    dp = jnp.concatenate([data, pad], axis=1).astype(jnp.uint32)

    def word4(off):
        return (dp[:, off:off + n]
                | (dp[:, off + 1:off + 1 + n] << 8)
                | (dp[:, off + 2:off + 2 + n] << 16)
                | (dp[:, off + 3:off + 3 + n] << 24))

    ctx = [word4(4 * k) for k in range(ctx_words)]
    w4 = ctx[0]

    iota = jax.lax.broadcasted_iota(jnp.int32, (b, n), 1)
    hashable = (iota + min_match) <= lengths[:, None]

    # Adaptive hash width: the sort key is (hash << pbits) | relpos with a
    # sentinel bucket at 1 << hb, so hb + pbits <= 31. Full-row 64K search
    # forces hb = 15 (the historical HASH_BITS); segmented windows
    # (pbits = 13 at W = 8192) leave room for 18 bits — 8x fewer false
    # bucket collisions, so the fixed probe budget reaches deeper REAL
    # predecessors at identical op count (speed-neutral, ratio-positive;
    # tools/ratiocheck.py). Capped at 18: beyond the window's occupancy
    # (~2^13 positions) more bits stop separating anything.
    if search_stride == 2 and 0 < search_seg < n:
        hash_pbits = max((search_seg // 2 - 1).bit_length(), 1)
    elif 0 < search_seg < n:
        hash_pbits = max((search_seg - 1).bit_length(), 1)
    else:
        hash_pbits = max((n - 1).bit_length(), 1)
    hb = min(18, 31 - hash_pbits)
    h = ((w4 * HASH_MUL) >> np.uint32(32 - hb)).astype(jnp.uint32)
    # unhashable positions go to a private overflow bucket
    h = jnp.where(hashable, h, np.uint32(1 << hb))

    if search_stride == 2 and 0 < search_seg < n:
        return _analyze_stride2(
            data, lengths, iota, h, ctx, b, n, min_match=min_match,
            max_match=max_match, window=window, parse_seg=parse_seg,
            ctx_words=ctx_words, probes=probes, lz4_rules=lz4_rules,
            search_seg=search_seg, search_overlap=search_overlap,
            hash_hi=np.uint32(1 << hb))

    # --- sort by (hash, pos); context rides along -------------------------
    # search_seg > 0 runs the sort pair over overlapped windows of WIDTH
    # W = search_seg (keep it a power of two — XLA pads the sort width up
    # to one) at stride own = W - ov; sort cost grows with row length, so
    # segmenting the search is the single biggest speed knob.
    segmented = 0 < search_seg < n
    if segmented:
        W = search_seg
        ov = min(search_overlap, W - 1)
        own = W - ov                        # positions owned per window
        nwin = -(-n // own)
        # padded layout: [ov synthetic] + data + [right junk]; window k
        # covers padded [k*own, k*own + W) and owns its last `own` slots
        pad_r = (nwin - 1) * own + W - ov - n
        pbits = max((W - 1).bit_length(), 1)

        def seg(x, fill):
            """(B, n) -> (B*nwin, W): overlapped power-of-two windows."""
            xp = jnp.concatenate(
                [jnp.full((b, ov), fill, x.dtype), x,
                 jnp.full((b, pad_r), fill, x.dtype)], axis=1)
            wins = [xp[:, k * own: k * own + W] for k in range(nwin)]
            return jnp.stack(wins, axis=1).reshape(b * nwin, W)

        relpos = jax.lax.broadcasted_iota(jnp.uint32, (b * nwin, W), 1)
        # synthetic pads go to the overflow bucket so they never become
        # candidates
        key = (seg(h, np.uint32(1 << hb)) << pbits) | relpos
        ctx_in = [seg(c, np.uint32(0)) for c in ctx]
    else:
        W, ov, own, nwin = n, 0, n, 1
        pbits = max((n - 1).bit_length(), 1)
        relpos = iota.astype(jnp.uint32)
        key = (h << pbits) | relpos
        ctx_in = ctx
    sorted_ops = jax.lax.sort((key, *ctx_in), dimension=1, num_keys=1,
                              is_stable=False)   # keys unique (relpos)
    key_s, ctx_s = sorted_ops[0], sorted_ops[1:]
    pos_s = (key_s & ((1 << pbits) - 1)).astype(jnp.int32)
    h_s = key_s >> pbits
    sb, sn = key_s.shape

    # packed probe accumulator: (ml << dbits) | (dmask - (dist-1)) — the
    # INVERTED distance makes "longest match, nearest on ties" a single
    # jnp.maximum per probe (larger ml wins; equal ml -> larger inverted
    # field = smaller dist = nearest predecessor, since bucket
    # predecessors at growing delta have strictly growing dist).
    # dbits must match how the unsort below unpacks: the single-operand
    # unsort keeps dist in pbits bits, the full-row fallback in 15 — so
    # decide the unsort path HERE, once (a segmented search can still
    # take the fallback when pos+ml+dist overflow 31 bits or ml
    # overflows its 5-bit field).
    one_op_unsort = segmented and 2 * pbits + 5 <= 31 and ctx_bytes <= 31
    dbits = pbits if one_op_unsort else 15
    dmask = np.uint32((1 << dbits) - 1)

    def cand_at(delta):
        """Match (len, dist) against the delta-th predecessor in the same
        hash bucket — pure shifts over the sorted operands. Returns the
        packed (ml, inverted-dist) candidate word (0 = no candidate)."""
        zpad = jnp.zeros((sb, delta), jnp.uint32)
        same = jnp.concatenate(
            [jnp.zeros((sb, delta), bool),
             h_s[:, delta:] == h_s[:, :-delta]], axis=1)
        dist = pos_s - jnp.concatenate(
            [jnp.zeros((sb, delta), jnp.int32), pos_s[:, :-delta]], axis=1)
        ml = jnp.zeros((sb, sn), jnp.int32)
        alive = same
        for k in range(ctx_words):
            prev = jnp.concatenate([zpad, ctx_s[k][:, :-delta]], axis=1)
            x = ctx_s[k] ^ prev
            full = (x == 0) & alive
            if k == 0:
                # a sub-4-byte prefix of word 0 can never reach
                # min_match (>= 4) — skip the dead partial compare
                ml = jnp.where(full, 4, 0)
            else:
                partial = jnp.where(
                    alive & ~full,
                    ((x & 0xFF) == 0).astype(jnp.int32)
                    + ((x & 0xFFFF) == 0).astype(jnp.int32)
                    + ((x & 0xFFFFFF) == 0).astype(jnp.int32),
                    0)
                ml = ml + jnp.where(full, 4, partial)
            alive = full
        ok = same & (dist >= 1) & (dist <= window) & (ml >= min_match)
        pk = ((ml.astype(jnp.uint32) << dbits)
              | (dmask - (dist - 1).astype(jnp.uint32)))
        return jnp.where(ok, pk, jnp.uint32(0))

    # probe the `probes` most recent same-hash predecessors (a deeper
    # chain than zlib L1's max_chain≈4 — each probe is just shifts in the
    # sorted domain); keep the longest match, nearest on ties
    cand = cand_at(1)
    for delta in range(2, probes + 1):
        cand = jnp.maximum(cand, cand_at(delta))
    # dist-1 = dmask - inv = dmask ^ inv (inv <= dmask); no-candidate
    # positions carry ml 0 (discarded by every consumer) and a junk dist

    # --- un-sort by position (a permutation → exact) ----------------------
    # segmented windows (pbits <= 13, ml <= ctx_bytes <= 31, dist < W):
    # position, length and distance all fit one u32 with position as the
    # TOP bits, so the un-sort is a SINGLE-operand sort of
    # (pos << (pbits+5)) | (ml << pbits) | (dist-1) — every extra
    # lax.sort operand is more bytes moved through the sort network
    if one_op_unsort:
        # cand ^ dmask un-inverts the distance field in place, yielding
        # (ml << pbits) | (dist-1) without extract/repack
        packed_p = jax.lax.sort(
            (pos_s.astype(jnp.uint32) << (pbits + 5)) | (cand ^ dmask),
            is_stable=False)                      # pos in top bits: unique
        # each window owns relpos in [ov, W); windows at stride own tile
        # the row (the last window may own a partial tail — trim to n)
        packed_p = packed_p.reshape(b, nwin, W)[:, :, ov:]
        packed_p = packed_p.reshape(b, nwin * own)[:, :n]
        ml = ((packed_p >> pbits) & 0x1F).astype(jnp.int32)
        # mask by pbits, not W-1: dist-1 occupies pbits bits and W may be
        # any width on this path
        dist = (packed_p & ((1 << pbits) - 1)).astype(jnp.int32) + 1
        return _analyze_tail(data, lengths, iota, ml, dist, b, n,
                             min_match, max_match, ctx_bytes, parse_seg,
                             lz4_rules)
    # full-row search: pack (ml, dist-1) into one carried operand (ml
    # <=15 bits even for LZ4's cap, dist-1 <=15 bits for the 32K window);
    # cand ^ dmask un-inverts the distance field in place
    _, packed_p = jax.lax.sort(
        (pos_s.astype(jnp.uint32), cand ^ dmask), dimension=1, num_keys=1,
        is_stable=False)                          # positions unique
    if segmented:
        packed_p = packed_p.reshape(b, nwin, W)[:, :, ov:]
        packed_p = packed_p.reshape(b, nwin * own)[:, :n]
    ml = (packed_p >> 15).astype(jnp.int32)
    dist = (packed_p & 0x7FFF).astype(jnp.int32) + 1
    return _analyze_tail(data, lengths, iota, ml, dist, b, n, min_match,
                         max_match, ctx_bytes, parse_seg, lz4_rules)


def _extend_matches(p, *, cap0, max_match, min_match, n, unit: int = 1):
    """Saturation-doubling match extension over a packed (ml<<16|dist-1)
    plane — pure shifts. A match saturated at length ``cap`` whose
    continuation position holds a same-distance match chains to
    cap + ml[cont]; lengths grow cap0 -> 2*cap0 -> ... -> max_match in
    log rounds. ``unit`` = bytes per plane element (2 on the stride-2
    even lattice, where byte offset cap is element shift cap//unit —
    every cap in the doubling ladder stays a multiple of the unit)."""
    cap = cap0
    while cap < max_match and cap < n * unit:
        np_ = _shl(p, cap // unit, 0)
        nml = (np_ >> 16).astype(jnp.int32)
        cont = (((p >> 16) == cap) & (((np_ ^ p) & 0xFFFF) == 0)
                & (nml >= min_match))
        ext = jnp.minimum(cap + nml, max_match).astype(jnp.uint32)
        p = jnp.where(cont, (ext << 16) | (p & 0xFFFF), p)
        cap *= 2
    return p


def _analyze_stride2(data, lengths, iota, h, ctx, b, n, *, min_match,
                     max_match, window, parse_seg, ctx_words, probes,
                     lz4_rules, search_seg, search_overlap,
                     hash_hi=np.uint32(1 << HASH_BITS)):
    """Half-lattice candidate search: sort EVEN positions only.

    The sort's cost is the comparison network over the key operand, so
    element count is the lever. Entering only even positions halves
    every sorted plane while the window's BYTE reach stays (even doubles,
    at equal sort width).

    REJECTED as the L1 default on ratio: the odd-distance match loss
    prices at −13.6% ratio on the mixed corpus (tools/ratiocheck.py:
    stride-2 W=16K/ov=2K → 0.901× zlib L1 vs 1.043× for the stride-1
    W=8K default) — losing every odd-distance repeat is fatal on text,
    and no cheap supplement recovers DISTANT odd matches. Kept (with a
    round-trip test) as the priced data point the next search-cost idea
    must beat.

    What the half lattice loses and how it's recovered:
      * matches at odd positions — recovered by derivation: expanding the
        even plane with repeat(x, 2) gives position 2a+1 the match of 2a
        minus one leading byte (same distance), which the byte-domain
        parse treats like any other candidate;
      * matches whose TRUE start is odd — the next even position inside
        the match carries the same (distance, suffix) candidate, so only
        the single leading byte is lost;
      * matches at ODD distances — invisible (both endpoints can't be
        even); this is the formulation's real ratio cost, priced with
        tools/ratiocheck.py.

    Extension runs on the even lattice BEFORE expansion (byte caps are
    even, so continuation positions stay on the lattice): half the HBM
    traffic of byte-domain doubling, and derived odd matches inherit
    fully extended lengths.
    """
    ctx_bytes = ctx_words * 4
    ne = n // 2

    def even(x):
        # static stride-2 slice (NOT an arbitrary gather); no (., 2)
        # intermediates
        return x[:, ::2]

    h_e = even(h)
    ctx_e = [even(c) for c in ctx]

    W = search_seg // 2                 # window width in even units
    ov = min(search_overlap // 2, W - 1)
    own = W - ov
    nwin = -(-ne // own)
    pad_r = (nwin - 1) * own + W - ov - ne
    pbits = max((W - 1).bit_length(), 1)
    assert 2 * pbits + 5 <= 31, "stride-2 unsort packing needs W <= 16K"

    def seg(x, fill):
        xp = jnp.concatenate(
            [jnp.full((b, ov), fill, x.dtype), x,
             jnp.full((b, pad_r), fill, x.dtype)], axis=1)
        wins = [xp[:, k * own: k * own + W] for k in range(nwin)]
        return jnp.stack(wins, axis=1).reshape(b * nwin, W)

    relpos = jax.lax.broadcasted_iota(jnp.uint32, (b * nwin, W), 1)
    key = (seg(h_e, hash_hi) << pbits) | relpos
    ctx_in = [seg(c, np.uint32(0)) for c in ctx_e]

    sorted_ops = jax.lax.sort((key, *ctx_in), dimension=1, num_keys=1,
                              is_stable=False)    # keys unique (relpos)
    key_s, ctx_s = sorted_ops[0], sorted_ops[1:]
    pos_s = (key_s & ((1 << pbits) - 1)).astype(jnp.int32)
    h_s = key_s >> pbits
    sb, sn = key_s.shape

    def cand_at(delta):
        zpad = jnp.zeros((sb, delta), jnp.uint32)
        same = jnp.concatenate(
            [jnp.zeros((sb, delta), bool),
             h_s[:, delta:] == h_s[:, :-delta]], axis=1)
        dist = pos_s - jnp.concatenate(
            [jnp.zeros((sb, delta), jnp.int32), pos_s[:, :-delta]], axis=1)
        ml = jnp.zeros((sb, sn), jnp.int32)
        alive = same
        for k in range(ctx_words):
            prev = jnp.concatenate([zpad, ctx_s[k][:, :-delta]], axis=1)
            x = ctx_s[k] ^ prev
            full = (x == 0) & alive
            partial = jnp.where(
                alive & ~full,
                ((x & 0xFF) == 0).astype(jnp.int32)
                + ((x & 0xFFFF) == 0).astype(jnp.int32)
                + ((x & 0xFFFFFF) == 0).astype(jnp.int32),
                0)
            ml = ml + jnp.where(full, 4, partial)
            alive = full
        # dist is in EVEN units; the byte distance is 2*dist
        ok = same & (dist >= 1) & (2 * dist <= window) & (ml >= min_match)
        return jnp.where(ok, ml, 0), jnp.where(ok, dist, 1)

    ml_s, dist_s = cand_at(1)
    for delta in range(2, probes + 1):
        mld, distd = cand_at(delta)
        better = mld > ml_s
        ml_s = jnp.where(better, mld, ml_s)
        dist_s = jnp.where(better, distd, dist_s)

    # single-operand unsort (pos in the top bits -> keys unique)
    packed_p = jax.lax.sort(
        (pos_s.astype(jnp.uint32) << (pbits + 5))
        | (ml_s.astype(jnp.uint32) << pbits)
        | (dist_s - 1).astype(jnp.uint32),
        is_stable=False)
    packed_p = packed_p.reshape(b, nwin, W)[:, :, ov:]
    packed_p = packed_p.reshape(b, nwin * own)[:, :ne]
    ml_e = ((packed_p >> pbits) & 0x1F).astype(jnp.uint32)
    dist_b = 2 * ((packed_p & ((1 << pbits) - 1)) + 1)  # byte distance

    # extension on the even lattice (unit=2): half the doubling traffic,
    # and derived odd matches inherit fully extended lengths
    p_e = (ml_e << 16) | (dist_b - 1).astype(jnp.uint32)
    p_e = _extend_matches(p_e, cap0=ctx_bytes, max_match=max_match,
                          min_match=min_match, n=ne, unit=2)

    # expand to the byte plane: repeat gives position 2a+1 the match of
    # 2a (same distance) — subtracting the parity bit derives the
    # one-byte-shorter odd candidate in the same op
    p_b = jnp.repeat(p_e, 2, axis=1)
    ml = jnp.maximum((p_b >> 16).astype(jnp.int32) - (iota & 1), 0)
    dist = (p_b & 0xFFFF).astype(jnp.int32) + 1
    return _analyze_tail(data, lengths, iota, ml, dist, b, n, min_match,
                         max_match, ctx_bytes, parse_seg, lz4_rules,
                         extend=False)


def _analyze_tail(data, lengths, iota, ml, dist, b, n, min_match,
                  max_match, ctx_bytes, parse_seg, lz4_rules,
                  extend: bool = True):
    """Post-candidate stages shared by the stride-1 and stride-2 search
    paths: match extension, lazy demotion, parse segmentation, greedy
    parse."""
    # --- saturation-doubling extension (pure shifts) ----------------------
    # (ml, dist-1) ride ONE u32 plane (ml <= max_match <= 32768 in the top
    # half, dist-1 <= 65535 below) so each doubling round moves half the
    # HBM bytes of the two-plane form
    p = (ml.astype(jnp.uint32) << 16) | (dist - 1).astype(jnp.uint32)
    if extend:
        p = _extend_matches(p, cap0=ctx_bytes, max_match=max_match,
                            min_match=min_match, n=n, unit=1)
    ml = (p >> 16).astype(jnp.int32)
    dist = (p & 0xFFFF).astype(jnp.int32) + 1

    ml = jnp.minimum(ml, lengths[:, None] - iota)
    is_match = ml >= min_match
    ml = jnp.where(is_match, ml, 0)

    # lazy matching (one shift): when the next position holds a strictly
    # longer match, emit this position as a literal so the greedy walk
    # takes the longer one — the zlib lazy-evaluation heuristic, which
    # level 1 doesn't even apply, so this pushes ratio past the baseline
    is_match = is_match & ~(_shl(ml, 1, 0) > ml)
    ml = jnp.where(is_match, ml, 0)

    # --- segment the PARSE (not the match search) -------------------------
    # Matches are trimmed at parse-segment boundaries so segments parse
    # independently (distances still reach across segments, so decode
    # semantics are untouched); ratio cost is ~avg_match/segment (<0.1% at
    # seg=8192, measured via tools/ratiocheck.py).
    seg = min(parse_seg, n)
    nseg = n // seg
    seg_rem = seg - (iota % seg)
    ml = jnp.minimum(ml, seg_rem)
    is_match = is_match & (ml >= min_match)
    ml = jnp.where(is_match, ml, 0)

    if lz4_rules:
        # LZ4 block end rules (qz_lz4_pack's demotions, csrc): no match
        # may start within the last 12 bytes, and the last 5 bytes are
        # always literals
        ml = jnp.minimum(ml, lengths[:, None] - 5 - iota)
        is_match = (is_match & (iota <= lengths[:, None] - 12)
                    & (ml >= min_match))
        ml = jnp.where(is_match, ml, 0)

    taken, lit = _parse_scan(is_match, ml, seg, nseg, b)
    valid = iota < lengths[:, None]
    lit = lit & valid
    return iota, ml, dist, taken, lit, valid


@functools.partial(jax.jit, static_argnames=("n", "min_match", "max_match",
                                             "window", "parse_seg",
                                             "ctx_words", "probes",
                                             "search_seg",
                                             "search_overlap",
                                             "search_stride",
                                             "compact_seg"))
def lz77_tokenize(data: jnp.ndarray, lengths: jnp.ndarray, *, n: int,
                  min_match: int = 4, max_match: int = 258,
                  window: int = 32768, parse_seg: int = 8192,
                  ctx_words: int = CTX_WORDS, probes: int = 6,
                  search_seg: int = 0, search_overlap: int = 1024,
                  search_stride: int = 1,
                  compact_seg: int = 0,
                  ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Tokenize a batch of chunks.

    Every stage is sorts, shifts and column scans — no per-element
    gathers or scatters:

      * candidates: one sort of (hash<<pbits|pos) carrying ``ctx_words``
        words of per-position context; predecessors in sort order are the
        exact most-recent previous occurrences, and match lengths are
        computed by comparing the CARRIED context words — zero gathers
      * un-sort: a second sort keyed on position (a permutation)
      * long matches: saturation doubling — a match saturated at length L
        whose continuation position i+L holds a same-distance match chains
        to L + ml[i+L]; i+L is a static shift, so lengths grow in log
        rounds of pure shifts up to max_match
      * greedy parse: a column-lockstep scan over segment lanes
      * compaction: one 2-operand sort moves emitted tokens to the prefix

    Args:
      data: (B, n) uint8, zero-padded beyond per-row ``lengths``.
      lengths: (B,) int32 valid byte count per row.
      n: static chunk capacity (power of two, <= 65536).
      min_match: minimum match length (>= 4; hash-4 candidates).
      max_match: cap on emitted match length (258 deflate, larger for LZ4).
      window: max backward distance (32768 deflate).

    Returns:
      tokens: (B, n) uint32 packed tokens, compacted to each row's prefix
              in position order (``compact_seg`` > 0: compacted to each
              compact_seg-segment's prefix instead; see below).
      ntok:   (B,) int32 token count per row, or (B, n/compact_seg) per
              segment when ``compact_seg`` > 0.
    """
    iota, ml, dist, taken, lit, valid = _analyze(
        data, lengths, n=n, min_match=min_match, max_match=max_match,
        window=window, parse_seg=parse_seg, ctx_words=ctx_words,
        probes=probes, search_seg=search_seg,
        search_overlap=search_overlap, search_stride=search_stride)
    b = data.shape[0]

    # --- literal runs over the POST-parse literal mask --------------------
    # lr[p] = forward run length starting at p, by saturation doubling
    # (pure rolls). Long runs are split at absolute RUN_SPLIT boundaries
    # (a run token never crosses one), so lr only needs exactness up to
    # RUN_SPLIT — RUN_SPLIT.bit_length() doubling rounds instead of 17,
    # and no backward-rank plane at all (costs a handful of extra tokens
    # on multi-KB runs). int16 planes: lr <= 2*RUN_SPLIT stays within
    # int16, and each doubling round moves half the HBM bytes of int32
    lr = lit.astype(jnp.int16)

    def lr_round(k, lr):
        span = jnp.int32(1) << k
        rolled = jnp.roll(lr, -span, axis=1)
        nlr = jnp.where(iota + span < n, rolled, jnp.int16(0))
        return jnp.where(lr == span.astype(jnp.int16), lr + nlr, lr)

    lr = jax.lax.fori_loop(0, RUN_SPLIT.bit_length(), lr_round, lr)
    lr = lr.astype(jnp.int32)

    # run tokens at run starts and at RUN_SPLIT-aligned positions inside
    # a run; lengths stop at the next boundary so the stream stays
    # position-consistent for the packers
    prev_lit = jnp.concatenate(
        [jnp.zeros((b, 1), bool), lit[:, :-1]], axis=1)
    at_split = (iota & (RUN_SPLIT - 1)) == 0
    runstart = lit & (~prev_lit | at_split)
    span_left = RUN_SPLIT - (iota & (RUN_SPLIT - 1))
    run_tok = TOK_LITRUN_BIT | jnp.minimum(lr, span_left).astype(jnp.uint32)
    match_tok = (TOK_MATCH_BIT
                 | (ml.astype(jnp.uint32) << 16)
                 | (dist - 1).astype(jnp.uint32))
    emit = taken | runstart
    tok = jnp.where(taken, match_tok,
                    jnp.where(runstart, run_tok, jnp.uint32(0)))

    # --- compaction: a 2-operand sort moves emitted tokens to each row's
    # (or compaction segment's) prefix in position order (no per-token
    # gather walk). compact_seg > 0 segments this sort too (sort cost grows
    # with row length — the same lever as search_seg): tokens land at each
    # CSEG-segment's prefix and ntok becomes (B, n/CSEG); the host (or the
    # bucketed d2h fetch) concatenates segment prefixes, which
    # merge_segment_tokens already handles.
    if 0 < compact_seg < n:
        cs = compact_seg
        ncs = n // cs
        ki = (iota % cs).astype(jnp.uint32)
        key = ki | ((~emit).astype(jnp.uint32) << 17)
        _, tokens = jax.lax.sort(
            (key.reshape(b * ncs, cs), tok.reshape(b * ncs, cs)),
            dimension=1, num_keys=1, is_stable=False)  # ki unique/segment
        tokens = tokens.reshape(b, n)
        ntok = jnp.sum(emit.reshape(b, ncs, cs), axis=2).astype(jnp.int32)
    else:
        key = iota.astype(jnp.uint32) | ((~emit).astype(jnp.uint32) << 17)
        _, tokens = jax.lax.sort((key, tok), dimension=1, num_keys=1,
                                 is_stable=False)  # iota unique per row
        ntok = jnp.sum(emit, axis=1).astype(jnp.int32)
    return tokens, ntok


@functools.partial(jax.jit, static_argnames=("n", "min_match", "max_match",
                                             "window", "parse_seg",
                                             "ctx_words", "probes",
                                             "search_seg", "search_overlap",
                                             "compact_seg"))
def lz77_tokenize_scan(data: jnp.ndarray, lengths: jnp.ndarray, *, n: int,
                       min_match: int = 4, max_match: int = 258,
                       window: int = 32768, parse_seg: int = 8192,
                       ctx_words: int = CTX_WORDS, probes: int = 6,
                       search_seg: int = 0, search_overlap: int = 1024,
                       compact_seg: int = 0,
                       ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Tokenize K chunk tiles in ONE device dispatch via ``lax.scan``.

    ``data`` is (K, B, n) and ``lengths`` (K, B); returns stacked
    (K, ...) outputs of :func:`lz77_tokenize`. The scan body reuses one
    tile's buffers, so the live set stays a single tile while the
    per-dispatch overhead amortizes K-fold — the deeper submission ring
    of the reference (NUM_BUFF=32 requests in flight per instance,
    qatzip_internal.h:63-68) expressed as a compiler loop.
    """
    def body(carry, xs):
        d, l = xs
        toks, ntok = lz77_tokenize(
            d, l, n=n, min_match=min_match, max_match=max_match,
            window=window, parse_seg=parse_seg, ctx_words=ctx_words,
            probes=probes, search_seg=search_seg,
            search_overlap=search_overlap, search_stride=1,
            compact_seg=compact_seg)
        return carry, (toks, ntok)

    _, (toks, ntok) = jax.lax.scan(body, jnp.int32(0), (data, lengths))
    return toks, ntok


# ---------------------------------------------------------------------------
# Host-side helpers
# ---------------------------------------------------------------------------

def merge_segment_tokens(tokens_row: np.ndarray, ntok_row,
                         parse_seg: int = 8192) -> np.ndarray:
    """One row's compact token stream (tokens are already row-compacted by
    the device; per-segment slicing kept for backward API compatibility
    with round-1 (B, nseg) ntok shapes)."""
    segs = np.atleast_1d(np.asarray(ntok_row)).ravel()
    tokens_row = np.asarray(tokens_row)
    if segs.size == 1:
        return tokens_row[: int(segs[0])]
    parts = [tokens_row[s * parse_seg: s * parse_seg + int(c)]
             for s, c in enumerate(segs) if int(c) > 0]
    if not parts:
        return np.zeros(0, np.uint32)
    return np.concatenate(parts)


def tokens_to_bytes(tokens: np.ndarray, ntok: int,
                    src: bytes = b"") -> bytes:
    """Reconstruct the chunk from packed tokens — the CnV-style verify
    oracle (reference runs compress-and-verify on every op,
    src/qatzip.c:1387). ``src`` supplies literal-run bytes."""
    out = bytearray()
    for t in np.asarray(tokens[:ntok], dtype=np.uint32):
        t = int(t)
        if t & 0x80000000:
            ml = (t >> 16) & 0x7FFF
            dist = (t & 0xFFFF) + 1
            start = len(out) - dist
            if start < 0:
                raise ValueError("bad token distance")
            for k in range(ml):
                out.append(out[start + k])
        elif t & 0x40000000:
            run = t & 0x3FFF
            pos = len(out)
            if pos + run > len(src):
                raise ValueError("literal run past end of source")
            out += src[pos:pos + run]
        else:
            out.append(t & 0xFF)
    return bytes(out)
