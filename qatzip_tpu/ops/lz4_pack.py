"""On-device LZ4 block packing — final bytes on device.

Same machinery as the deflate device packer (dense per-position
emissions, cumsum offsets, group-window OR-packing, one scatter-add
assembly), at BYTE granularity. The LZ4 format constraint driving the
design: only the FINAL sequence may be literal-only, so
literal runs cannot be split — a run's litlen extension bytes must ride
one emission. Emissions stay <= 4 bytes (one u32 word) by

  * capping matches at 273 (stored nibble overflow <= 254 -> exactly one
    mlext byte; longer true matches naturally continue as back-to-back
    sequences with zero literals, which is legal mid-stream), and
  * packing only chunks whose literal runs are <= 270 (token + <= 2 ext
    bytes + the run's own first literal = 4 bytes). Chunks with longer
    runs are reported not-OK and the caller routes them to the host LZ4
    coder — long runs mean incompressible-ish data where the host path
    (or a stored frame block) wins anyway.

Per-position emissions:
  run start p:   token(litnibble, next-match nibble from a first-nonzero-
                 right fill of match lengths) + litlen ext bytes + p's own
                 literal byte
  literal p:     its byte
  match start m: [own token when no literal run precedes] + 2-byte offset
                 + mlext byte

Reference analog: the QAT silicon emits final LZ4 block bytes
(src/qatzip.c:1445 single-call compress); host leg is qz_lz4_pack (csrc).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from .lz77 import _analyze
from .deflate_pack import _group_pack_assemble

LZ4_MAX_MATCH = 273     # stored nibble ext <= 254: exactly one mlext byte
LZ4_MAX_RUN = 270       # token + <=2 litlen ext bytes
LZ4_GROUP_W = 112       # worst group: ~1.6 emitted bytes/position


@functools.partial(jax.jit, static_argnames=("n", "max_words"))
def lz4_pack_device(data: jnp.ndarray, lengths: jnp.ndarray, *, n: int,
                    max_words: int = 0,
                    ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Pack a chunk batch into LZ4 block bytes on device.

    Returns (words (B, max_words) u32 LE, nbytes (B,) i32, ok (B,) bool).
    Rows with ok=False contain a literal run longer than LZ4_MAX_RUN and
    must be packed by the host coder instead.
    """
    b = data.shape[0]
    if max_words == 0:
        max_words = (2 * n) // 4 + 4     # 2 bytes/position upper bound
    iota, ml, dist, taken, lit, valid = _analyze(
        data, lengths, n=n, min_match=4, max_match=LZ4_MAX_MATCH,
        window=32768, parse_seg=8192, ctx_words=4, probes=6,
        lz4_rules=True)

    # forward literal-run lengths (exact up to n)
    lr = lit.astype(jnp.int32)

    def lr_round(k, lr):
        span = jnp.int32(1) << k
        rolled = jnp.roll(lr, -span, axis=1)
        nlr = jnp.where(iota + span < n, rolled, 0)
        return jnp.where(lr == span, lr + nlr, lr)

    lr = jax.lax.fori_loop(0, int(n - 1).bit_length(), lr_round, lr)
    ok = jnp.max(lr, axis=1) <= LZ4_MAX_RUN

    prev_lit = jnp.concatenate(
        [jnp.zeros((b, 1), bool), lit[:, :-1]], axis=1)
    runstart = lit & ~prev_lit

    # next-match length after each run: first nonzero to the right within
    # [p, p+2^k) — doubling is exact for the nearest nonzero
    nm = jnp.where(taken, ml, 0)

    def nm_round(k, nm):
        span = jnp.int32(1) << k
        rolled = jnp.roll(nm, -span, axis=1)
        right = jnp.where(iota + span < n, rolled, 0)
        return jnp.where(nm == 0, right, nm)

    nm = jax.lax.fori_loop(0, 10, nm_round, nm)   # window 1024 >= 270+273

    # --- emissions (byte counts and LE byte values in a u32) --------------
    # run start: token + litlen ext + own literal byte
    L = lr
    stored_next = jnp.maximum(nm - 4, 0)
    mnib = jnp.where(nm > 0, jnp.minimum(stored_next, 15), 0)
    token = (jnp.minimum(L, 15) << 4) | mnib
    e1 = jnp.minimum(L - 15, 255)                  # first ext byte
    e2 = L - 15 - 255                              # second (L == 270 only)
    rs_nb = 1 + (L >= 15).astype(jnp.int32) + (L >= 270).astype(jnp.int32)
    lit_byte = data.astype(jnp.uint32)
    rs_val = token.astype(jnp.uint32)
    rs_val = jnp.where(L >= 15, rs_val | (e1.astype(jnp.uint32) << 8),
                       rs_val)
    rs_val = jnp.where(L >= 270, rs_val | (e2.astype(jnp.uint32) << 16),
                       rs_val)
    rs_val = rs_val | (lit_byte << (rs_nb * 8))
    rs_nb = rs_nb + 1                              # the literal byte

    # plain literal: one byte
    pl_val = lit_byte
    pl_nb = jnp.ones_like(rs_nb)

    # match start: [own token if not preceded by a literal] + offset + ext
    stored = jnp.maximum(ml - 4, 0)
    own_token = taken & ~prev_lit                  # zero-literal sequence
    m_tok = jnp.minimum(stored, 15).astype(jnp.uint32)  # litnibble = 0
    off_lo = (dist & 0xFF).astype(jnp.uint32)
    off_hi = (dist >> 8).astype(jnp.uint32)
    m_ext = (stored - 15).astype(jnp.uint32)       # <= 254 by the 273 cap
    m_val0 = off_lo | (off_hi << 8)                # token already emitted
    m_val0 = jnp.where(stored >= 15, m_val0 | (m_ext << 16), m_val0)
    m_nb0 = 2 + (stored >= 15).astype(jnp.int32)
    m_val1 = m_tok | (off_lo << 8) | (off_hi << 16)
    m_val1 = jnp.where(stored >= 15, m_val1 | (m_ext << 24), m_val1)
    m_nb1 = 3 + (stored >= 15).astype(jnp.int32)
    m_val = jnp.where(own_token, m_val1, m_val0)
    m_nb = jnp.where(own_token, m_nb1, m_nb0)

    vals = jnp.where(taken, m_val,
                     jnp.where(runstart, rs_val,
                               jnp.where(lit, pl_val, jnp.uint32(0))))
    nbs = jnp.where(taken, m_nb,
                    jnp.where(runstart, rs_nb,
                              jnp.where(lit, pl_nb, 0)))

    csum = jnp.cumsum(nbs, axis=1, dtype=jnp.int32)
    off_bytes = csum - nbs
    total_bytes = csum[:, -1]

    out = _group_pack_assemble(vals, nbs * 8, off_bytes * 8, b, n,
                               max_words, group_w=LZ4_GROUP_W)
    return out, total_bytes.astype(jnp.int32), ok
