"""Batched CRC32 on the matrix units via GF(2) linear algebra.

CRC32 is affine over GF(2): crc(M) = crc(0^n) XOR L(M) where L is linear
in the message bits. For a fixed message length n, L is a (8n × 32)
bit-matrix V, so a whole batch of chunk CRCs is ONE matmul:

    counts[B, 32] = bits[B, 8n] @ V[8n, 32]      (bf16, tensor cores)
    crc[B]        = crc(0^n) XOR packbits(counts & 1)

f32 accumulation is exact for counts <= 2^24 (8n = 524288 < 2^24 for the
64 KB chunk), so the parity is exact. This replaces the per-chunk host
crc32 of the engine's ordered-retirement path (the reference gets CRCs
from QAT hardware alongside each chunk, src/qatzip.c:1838-1853) with an
on-device computation that rides the same batch as the tokenizer.

Only full-length rows (length == n) use the matrix; ragged tails fall
back to host zlib.crc32 (the matrix encodes distance-from-end, which
changes with the message length).
"""

from __future__ import annotations

import functools
import threading
from typing import Dict

import numpy as np

_CRC_TABLE = None
_v_cache: Dict[int, np.ndarray] = {}
_zero_crc_cache: Dict[int, int] = {}
_lock = threading.Lock()


def _crc_table() -> np.ndarray:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = np.uint32(0xEDB88320)
        t = np.arange(256, dtype=np.uint32)
        for _ in range(8):
            t = np.where(t & 1, (t >> np.uint32(1)) ^ poly,
                         t >> np.uint32(1))
        _CRC_TABLE = t
    return _CRC_TABLE


def _build_v(n: int) -> np.ndarray:
    """V[i*8+k] = L(bit k of byte i) for an n-byte message — built by
    advancing the 8 single-bit seeds through trailing zero bytes with the
    (linear) byte-0 crc update, vectorized over distances."""
    tab = _crc_table()
    # seeds: message = single byte with bit k set, zero trailing distance
    seeds = np.zeros(8, np.uint32)
    zero_single = np.uint32(0)
    for k in range(8):
        # linear part of one-byte update for byte (1<<k), minus the
        # zero-byte update (cancels the affine init/xorout terms)
        b = np.uint32(1 << k)
        seeds[k] = tab[b & 0xFF] ^ tab[0]
    # V rows ordered by byte position i (distance d = n-1-i)
    v = np.empty((n, 8), np.uint32)
    cur = seeds.copy()
    v[n - 1] = cur
    for d in range(1, n):
        cur = (cur >> np.uint32(8)) ^ tab[cur & np.uint32(0xFF)]
        v[n - 1 - d] = cur
    return v.reshape(n * 8, 1)  # bits expanded later


def _v_bits(n: int) -> np.ndarray:
    """(8n, 32) float matrix of V's bits (bit j of row value)."""
    with _lock:
        got = _v_cache.get(n)
        if got is not None:
            return got
        v = _build_v(n).reshape(-1)              # (8n,) u32
        bits = ((v[:, None] >> np.arange(32, dtype=np.uint32)[None, :])
                & 1).astype(np.float32)
        _v_cache[n] = bits
        return bits


def _zero_crc(n: int) -> int:
    import zlib

    with _lock:
        got = _zero_crc_cache.get(n)
        if got is None:
            got = zlib.crc32(b"\x00" * n) & 0xFFFFFFFF
            _zero_crc_cache[n] = got
        return got


@functools.partial(lambda f: f)
def crc32_batch_device(data, *, n: int):
    """Device-side CRC32 of every full-length row of ``data`` (B, n) u8.

    Returns a (B,) uint32 jax array. Rows shorter than n (zero-padded)
    get the crc of the PADDED message — callers must use host crc32 for
    ragged rows (see DeviceEngine).
    """
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=("n",))
    def _crc(data, v, zero_crc, n):
        # expand bytes to bits: (B, n) u8 -> (B, 8n) bf16, LSB-first to
        # match the reflected crc32 bit order
        d = data.astype(jnp.uint8)
        shifts = jnp.arange(8, dtype=jnp.uint8)
        bits = ((d[:, :, None] >> shifts[None, None, :]) & 1)
        bits = bits.reshape(d.shape[0], n * 8).astype(jnp.bfloat16)
        counts = jnp.dot(bits, v.astype(jnp.bfloat16),
                         preferred_element_type=jnp.float32)
        parity = counts.astype(jnp.int32) & 1                  # (B, 32)
        weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
        lin = jnp.sum(parity.astype(jnp.uint32) * weights[None, :],
                      axis=1, dtype=jnp.uint32)
        return lin ^ zero_crc

    # V passed as an argument (a closure constant would fold a multi-MB
    # literal into the HLO, stalling compilation); jax.jit caches by
    # function identity, so _crc must be defined once per process
    global _crc_cached
    try:
        fn = _crc_cached
    except NameError:
        fn = _crc
        _crc_cached = fn
    vbits = _v_bits(n).astype(np.float32)
    return fn(jnp.asarray(data), jnp.asarray(vbits),
              jnp.uint32(_zero_crc(n)), n=n)
