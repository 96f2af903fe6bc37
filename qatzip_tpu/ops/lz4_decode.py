"""Device-side LZ4 block decode — batched match-chain resolution.

The reference offloads the whole decompress loop to QAT silicon
(cpaDcDecompressData, src/qatzip.c:2543). LZ4 decode's only serial part
is the window copy: each match byte copies an earlier OUTPUT byte, so
decode order matters. The device formulation splits it:

  * host (csrc qz_lz4_ref_block): one linear parse builds a reference
    plane — ref[i] is the literal byte (encoded negative) or the earlier
    output index it copies from. No byte shuffling, memset-class cost.
  * device (resolve_refs): pointer doubling — ref = ref[ref] until every
    entry is a resolved literal. Chains of depth D resolve in ceil(log2 D)
    rounds of batched gathers over the whole member batch.

The device leg exists, is correct, and is selected only via
QZTPU_DEVICE_DECODE=1; the default router sends members to the host pool
(batched native LZ4 decode), as the reference routes non-processable
requests to software (isQATProcessable, src/qatzip.c:2886-2899). Its
speed on the GPU is not measured yet.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("max_rounds",))
def resolve_refs(ref: jnp.ndarray, max_rounds: int):
    """Resolve a (B, n) reference plane to output bytes (uint8).

    ref[i] < 0: resolved literal, value -(byte+1); ref[i] >= 0: copy from
    output index ref[i] (always < i, so chains are bounded by n and
    ceil(log2(n)) doubling rounds resolve everything — max_rounds must be
    derived from n by the caller). Also returns an unresolved flag so the
    caller can hard-fail instead of emitting garbage.
    """
    def cond(state):
        r, i = state
        return (i < max_rounds) & jnp.any(r >= 0)

    def body(state):
        r, i = state
        tgt = jnp.clip(r, 0, r.shape[1] - 1)
        chased = jnp.take_along_axis(r, tgt, axis=1)
        return jnp.where(r >= 0, chased, r), i + 1

    r, _ = jax.lax.while_loop(cond, body, (ref, jnp.int32(0)))
    return (-r - 1).astype(jnp.uint8), jnp.any(r >= 0)


def decode_blocks_device(payloads: Sequence[bytes],
                         expected_sizes: Sequence[int]) -> List[bytes]:
    """Decode a batch of LZ4 blocks with device-side chain resolution."""
    from .. import native

    if native.lib is None:
        raise RuntimeError("native parser unavailable")
    n = 1
    for sz in expected_sizes:
        while n < max(sz, 1):
            n <<= 1
    b = len(payloads)
    refs = np.zeros((b, n), np.int32) - 1   # -1 == literal 0 padding
    outlens = []
    import ctypes
    i32p = ctypes.POINTER(ctypes.c_int32)
    for i, p in enumerate(payloads):
        sa = np.frombuffer(p, np.uint8) if p else np.empty(1, np.uint8)
        r = native.lib._lib.qz_lz4_ref_block(
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(p),
            refs[i].ctypes.data_as(i32p), n)
        if r < 0 or r > expected_sizes[i]:
            raise ValueError("malformed LZ4 block")
        outlens.append(int(r))
    rounds = max((n - 1).bit_length() + 1, 1)
    out, unresolved = resolve_refs(jnp.asarray(refs), max_rounds=rounds)
    if bool(unresolved):   # cannot happen for refs < n; defense in depth
        raise ValueError("unresolved LZ4 copy chain")
    out = np.asarray(out)
    return [out[i, :outlens[i]].tobytes() for i in range(b)]
