"""The plain-XLA device paths that every backend runs: the windowed
candidate search, the strip-reduce symbol histogram, and the scatter-add
(static) and sort-merge (dynamic) Huffman packs, each checked against an
independent reference (the source bytes, np.bincount, stock zlib)."""

import zlib

import numpy as np
import pytest

import jax.numpy as jnp

from qatzip_tpu import native

# RFC 1951 3.2.5 base values: length symbols 257.., distance symbols 0..
_LEN_BASE = np.array([3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27,
                      31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195,
                      227, 258])
_DIST_BASE = np.array([1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97,
                       129, 193, 257, 385, 513, 769, 1025, 1537, 2049,
                       3073, 4097, 6145, 8193, 12289, 16385, 24577])


def _mixed_batch(n, rows=4, seed=7):
    rng = np.random.default_rng(seed)
    rec = bytes(rng.integers(0, 256, 333, dtype=np.uint8))
    data = np.stack([
        np.frombuffer((b"the quick brown fox " * (n // 16 + 2))[:n],
                      np.uint8),
        rng.integers(0, 256, n, dtype=np.uint8),
        rng.choice(np.frombuffer(b"ACGT", np.uint8), n),
        np.frombuffer((rec * (n // 333 + 2))[:n], np.uint8),
    ][:rows])
    lengths = np.full(rows, n, np.int32)
    lengths[2] = max(1, n - 700)
    data[2, lengths[2]:] = 0
    return data, lengths


@pytest.mark.parametrize("n,search_seg,overlap",
                         [(16384, 8192, 1024), (4096, 1024, 256)])
def test_windowed_search_tokens_rebuild_source(n, search_seg, overlap):
    """Overlapped-window candidate search (one full window and a partial
    tail window) emits tokens that rebuild every row exactly."""
    from qatzip_tpu.ops.lz77 import lz77_tokenize, tokens_to_bytes

    data, lengths = _mixed_batch(n)
    toks, ntok = lz77_tokenize(jnp.asarray(data), jnp.asarray(lengths), n=n,
                               search_seg=search_seg,
                               search_overlap=overlap)
    toks, ntok = np.asarray(toks), np.asarray(ntok)
    matches = 0
    for i in range(data.shape[0]):
        src = data[i, :lengths[i]].tobytes()
        row = toks[i, :int(ntok[i])]
        matches += int(np.sum(row >> 31))
        assert tokens_to_bytes(row, len(row), src) == src
    assert matches > 0                  # the search found back-references


def test_strip_histogram_matches_bincount():
    """Pass-1 strip compare-reduce == np.bincount over the parse's
    literal bytes, length symbols and distance symbols."""
    from qatzip_tpu.ops.deflate_pack import deflate_analyze_hist

    n = 2048
    data, lengths = _mixed_batch(n)
    hist, ml, dist, taken, lit = deflate_analyze_hist(
        jnp.asarray(data), jnp.asarray(lengths), n=n)
    hist, ml, dist = np.asarray(hist), np.asarray(ml), np.asarray(dist)
    taken, lit = np.asarray(taken), np.asarray(lit)
    assert hist.shape == (data.shape[0], 316)
    for i in range(data.shape[0]):
        t = taken[i]
        lsym = 257 + np.searchsorted(_LEN_BASE, ml[i][t], side="right") - 1
        dsym = np.searchsorted(_DIST_BASE, dist[i][t], side="right") - 1
        syms = np.concatenate([data[i][lit[i]].astype(np.int64), lsym,
                               286 + dsym])
        want = np.bincount(syms, minlength=316)
        assert np.array_equal(hist[i], want), f"row {i}"


@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_xla_packs_decode_with_zlib(mode):
    """The scatter-add window assembly (static codes) and the sort-merge
    code lookup (per-chunk dynamic trees) emit streams stock zlib decodes
    byte-exact."""
    from qatzip_tpu.ops.deflate_pack import (deflate_analyze_hist,
                                             deflate_pack_device,
                                             deflate_pack_dynamic,
                                             finish_stream,
                                             finish_stream_dynamic)
    if native.lib is None:
        pytest.skip("native lib unavailable")
    n = 2048
    data, lengths = _mixed_batch(n)
    dd, ll = jnp.asarray(data), jnp.asarray(lengths)
    b = data.shape[0]
    if mode == "static":
        words, nbits = deflate_pack_device(dd, ll, n=n)
        words, nbits = np.asarray(words), np.asarray(nbits)
        streams = [finish_stream(words[i], int(nbits[i]), final=True)
                   for i in range(b)]
    else:
        hist, ml, dist, taken, lit = deflate_analyze_hist(dd, ll, n=n)
        hist = np.asarray(hist)
        packs = np.zeros((b, 286), np.uint16)
        dpacks = np.zeros((b, 30), np.uint16)
        hdrs, hbits = [], np.zeros(b, np.int32)
        for i in range(b):
            lf = hist[i, :286].astype(np.uint32)
            lf[256] += 1
            packs[i], dpacks[i], hb, hbits[i] = native.lib.dyn_plan(
                lf, hist[i, 286:].astype(np.uint32))
            hdrs.append(hb)
        words, nbits = deflate_pack_dynamic(
            dd, ml, dist, taken, lit, jnp.asarray(packs.astype(np.uint32)),
            jnp.asarray(dpacks.astype(np.uint32)), jnp.asarray(hbits), n=n)
        words, nbits = np.asarray(words), np.asarray(nbits)
        streams = [finish_stream_dynamic(words[i], int(nbits[i]), hdrs[i],
                                         int(packs[i][256]), final=True)
                   for i in range(b)]
    for i, stream in enumerate(streams):
        assert (zlib.decompressobj(-15).decompress(stream)
                == data[i, :lengths[i]].tobytes()), f"{mode} row {i}"
