"""On-device static-Huffman bit-packer: byte-exact deflate vs stock zlib.

The device emits final bitstream words (ops/deflate_pack.py); the host
only flips BFINAL / appends the full-flush sync. Every stream here is
decoded by stock zlib and compared byte-exact — the same bar the host
packer meets (reference CnV philosophy, src/qatzip.c:1387).
"""

import os
import zlib

import numpy as np
import pytest

import jax.numpy as jnp

from qatzip_tpu.ops.deflate_pack import deflate_pack_device, finish_stream


def _pack_rows(rows, n, lengths=None):
    b = len(rows)
    data = np.zeros((b, n), np.uint8)
    lens = np.zeros(b, np.int32)
    for i, r in enumerate(rows):
        a = np.frombuffer(r, np.uint8)
        data[i, : len(a)] = a
        lens[i] = len(a)
    if lengths is not None:
        lens = np.asarray(lengths, np.int32)
    words, nbits = deflate_pack_device(jnp.asarray(data), jnp.asarray(lens),
                                       n=n)
    return np.asarray(words), np.asarray(nbits), lens


CORPORA = [
    b"hello world hello world hello hello world!" * 30,
    bytes(range(256)) * 16,                          # all byte values, 9-bit
    b"A" * 5000,                                     # long single-run
    os.urandom(4096),                                # incompressible
    b"",                                             # empty chunk
    b"x",                                            # single byte
    (b"abcdefgh" * 100 + os.urandom(64)) * 4,        # mixed
]


def test_device_pack_decodes_with_stock_zlib():
    n = 4096
    rows = [c[:n] for c in CORPORA]
    words, nbits, lens = _pack_rows(rows, n)
    for i, row in enumerate(rows):
        stream = finish_stream(words[i], int(nbits[i]), final=True)
        out = zlib.decompressobj(-15).decompress(stream)
        assert out == row, f"row {i} mismatch ({len(out)} vs {len(row)})"


def test_device_pack_full_flush_concatenation():
    """Non-final chunks end with the empty-stored-block sync; byte-level
    concatenation must form one valid raw stream (the multi-chunk RAW
    path, reference FLUSH_FULL per chunk, src/qatzip.c:1384-1394)."""
    n = 2048
    pieces = [b"chunk one " * 100, b"chunk two differs " * 80,
              os.urandom(1500)]
    words, nbits, _ = _pack_rows([p[:n] for p in pieces], n)
    blob = b"".join(
        finish_stream(words[i], int(nbits[i]), final=(i == len(pieces) - 1))
        for i in range(len(pieces)))
    out = zlib.decompressobj(-15).decompress(blob)
    assert out == b"".join(p[:n] for p in pieces)


def test_device_pack_64k_silesia_slice():
    n = 65536
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from bench import make_corpus
    blob = make_corpus(1)
    rows = [blob[i * n:(i + 1) * n] for i in range(4)]
    words, nbits, _ = _pack_rows(rows, n)
    total = 0
    for i, row in enumerate(rows):
        stream = finish_stream(words[i], int(nbits[i]), final=True)
        assert zlib.decompressobj(-15).decompress(stream) == row
        total += len(stream)
    # static Huffman should still beat stored and be in zlib's ballpark
    assert total < sum(len(r) for r in rows)


def test_device_pack_matches_host_static_sizes():
    """Device static pack and the host static packer consume the same
    parse, so sizes should be close (both are static-Huffman greedy)."""
    from qatzip_tpu import native
    if native.lib is None:
        pytest.skip("native lib unavailable")
    from qatzip_tpu.ops.lz77 import lz77_tokenize
    n = 8192
    row = ((b"the quick brown fox " * 300 + os.urandom(512)) * 2)[:n]
    assert len(row) == n
    words, nbits, _ = _pack_rows([row], n)
    dev_stream = finish_stream(words[0], int(nbits[0]), final=True)

    data = np.zeros((1, n), np.uint8)
    data[0] = np.frombuffer(row.ljust(n, b"\0"), np.uint8)
    toks, ntok = lz77_tokenize(jnp.asarray(data),
                               jnp.asarray(np.array([n], np.int32)), n=n)
    host_stream = native.lib.deflate_pack(row.ljust(n, b"\0"),
                                          np.asarray(toks)[0],
                                          int(np.asarray(ntok)[0]),
                                          final=True, mode=1)
    assert zlib.decompressobj(-15).decompress(dev_stream) == row.ljust(n,
                                                                       b"\0")
    assert abs(len(dev_stream) - len(host_stream)) <= 16


def test_static_sessions_route_to_device_pack(monkeypatch):
    """huffman_hdr=STATIC sessions compress through the full-device
    packer by default (QZTPU_DEVICE_PACK=auto) and still round-trip
    byte-exact through stock zlib."""
    import zlib as _z
    monkeypatch.delenv("QZTPU_DEVICE_PACK", raising=False)
    import qatzip_tpu as qz
    from qatzip_tpu import params as P
    from qatzip_tpu.constants import HuffmanHdr
    from qatzip_tpu.runtime import get_runtime
    if not get_runtime().hw_available:
        pytest.skip("no engine backend")
    p = P.get_defaults("deflate")
    p.huffman_hdr = HuffmanHdr.STATIC_HDR
    s = qz.QzSession()
    s.setup_deflate(p)
    data = (b"static-session device pack " * 4000
            + os.urandom(3000))
    out = s.compress(data)
    pieces, pos = [], 0
    while pos < len(out):
        do = _z.decompressobj(31)
        pieces.append(do.decompress(out[pos:]) + do.flush())
        pos = len(out) - len(do.unused_data)
        if not do.unused_data:
            break
    assert b"".join(pieces) == data
    s2 = qz.QzSession()
    s2.setup_deflate()
    assert s2.decompress(out) == data


def _dyn_pack_rows(rows, n):
    from qatzip_tpu import native
    from qatzip_tpu.ops.deflate_pack import (deflate_analyze_hist,
                                             deflate_pack_dynamic,
                                             finish_stream_dynamic)
    b = len(rows)
    data = np.zeros((b, n), np.uint8)
    lens = np.zeros(b, np.int32)
    for i, r in enumerate(rows):
        a = np.frombuffer(r, np.uint8)
        data[i, : len(a)] = a
        lens[i] = len(a)
    hist, ml, dist, taken, lit = deflate_analyze_hist(
        jnp.asarray(data), jnp.asarray(lens), n=n)
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
        jnp.asarray(data), ml, dist, taken, lit,
        jnp.asarray(packs.astype(np.uint32)),
        jnp.asarray(dpacks.astype(np.uint32)), jnp.asarray(hbits), n=n)
    words, nbits = np.asarray(words), np.asarray(nbits)
    return [finish_stream_dynamic(words[i], int(nbits[i]), hdrs[i],
                                  int(packs[i][256]), final=True)
            for i in range(b)]


def test_dynamic_device_pack_decodes_with_stock_zlib():
    from qatzip_tpu import native
    if native.lib is None:
        pytest.skip("native lib unavailable")
    n = 4096
    rows = [c[:n] for c in CORPORA]
    # DNA-like data is where static loses 4x — the dynamic tree must win
    rng = np.random.default_rng(1)
    rows.append(rng.choice(np.frombuffer(b"ACGT", np.uint8), n).tobytes())
    streams = _dyn_pack_rows(rows, n)
    for row, stream in zip(rows, streams):
        assert zlib.decompressobj(-15).decompress(stream) == row


def test_dynamic_device_pack_far_distance_32bit_emission():
    """Regression: dist >= 16385 plus a long length code produces a full
    32-bit emission; as int32 its straddle was sign-extended into garbage
    (first seen as 'invalid distance too far back' at 32K chunks)."""
    from qatzip_tpu import native
    if native.lib is None:
        pytest.skip("native lib unavailable")
    n = 32768
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, n, dtype=np.uint8)
    base[20000:20220] = base[0:220]     # len-220 match at dist 20000
    (stream,) = _dyn_pack_rows([base.tobytes()], n)
    assert zlib.decompressobj(-15).decompress(stream) == base.tobytes()


def test_dynamic_device_pack_64k_mixed():
    from qatzip_tpu import native
    if native.lib is None:
        pytest.skip("native lib unavailable")
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from bench import make_corpus
    n = 65536
    blob = make_corpus(1)
    rows = [blob[i * n:(i + 1) * n] for i in range(6)]
    streams = _dyn_pack_rows(rows, n)
    dyn_total = 0
    for row, stream in zip(rows, streams):
        assert zlib.decompressobj(-15).decompress(stream) == row
        dyn_total += len(stream)
    # dynamic should be in the ballpark of zlib L1 (static loses ~46%
    # on this mix — the whole point of the dynamic device path)
    zl = sum(len(zlib.compress(r, 1)) for r in rows)
    assert dyn_total < zl * 1.05


def test_device_packers_property_fuzz():
    """Random content/length property fuzz across all three device
    packers — every stream must decode byte-exact."""
    from qatzip_tpu import native
    if native.lib is None:
        pytest.skip("native lib unavailable")
    from qatzip_tpu.ops.lz4_pack import lz4_pack_device
    rng = np.random.default_rng(42)
    n = 8192
    rows = []
    for _ in range(24):
        kind = rng.integers(0, 5)
        ln = int(rng.integers(0, n + 1))
        if kind == 0:
            row = rng.integers(0, 256, ln, dtype=np.uint8).tobytes()
        elif kind == 1:
            row = bytes(rng.integers(0, 4, ln, dtype=np.uint8) + 65)
        elif kind == 2:
            pat = rng.integers(0, 256, max(int(rng.integers(1, 400)), 1),
                               dtype=np.uint8).tobytes()
            row = (pat * (ln // max(len(pat), 1) + 1))[:ln]
        elif kind == 3:
            row = bytes([int(rng.integers(0, 256))]) * ln
        else:
            half = rng.integers(0, 256, ln // 2 + 1,
                                dtype=np.uint8).tobytes()
            row = (half + half)[:ln]
        rows.append(row)

    # static device pack
    words, nbits, lens = _pack_rows(rows, n)
    for i, row in enumerate(rows):
        stream = finish_stream(words[i], int(nbits[i]), final=True)
        assert zlib.decompressobj(-15).decompress(stream) == row, \
            f"static row {i}"
    # dynamic device pack
    streams = _dyn_pack_rows(rows, n)
    for i, row in enumerate(rows):
        assert zlib.decompressobj(-15).decompress(streams[i]) == row, \
            f"dynamic row {i}"
    # LZ4 device pack (ok rows only; not-ok -> host fallback by design)
    import jax.numpy as _jnp
    data = np.zeros((len(rows), n), np.uint8)
    lns = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        data[i, :len(r)] = np.frombuffer(r, np.uint8)
        lns[i] = len(r)
    w4, nb4, ok4 = lz4_pack_device(_jnp.asarray(data), _jnp.asarray(lns),
                                   n=n)
    w4, nb4, ok4 = np.asarray(w4), np.asarray(nb4), np.asarray(ok4)
    for i, row in enumerate(rows):
        if not ok4[i] or not row:
            continue
        payload = w4[i][: (int(nb4[i]) + 3) // 4].tobytes()[: int(nb4[i])]
        assert native.lib.lz4_decompress_block(payload, len(row)) == row, \
            f"lz4 row {i}"


def test_dynamic_engine_path_single_device(monkeypatch):
    """Drive _compress_device_packed's dynamic two-pass branch through a
    single-device engine: multi-tile lookahead, stored guard, and framing
    must produce stock-zlib-exact members."""
    from qatzip_tpu import native
    if native.lib is None:
        pytest.skip("native lib unavailable")
    monkeypatch.setenv("QZTPU_DEVICE_PACK", "1")
    monkeypatch.setenv("QZTPU_TILE_B", "256")
    import jax
    from qatzip_tpu.parallel.dispatch import DeviceEngine
    rng = np.random.default_rng(9)
    eng = DeviceEngine([jax.devices()[0]], "deflate")
    chunks = [
        (b"dyn engine " * 7000)[:65536],
        rng.integers(0, 256, 65536, dtype=np.uint8).tobytes(),  # stored
        rng.choice(np.frombuffer(b"ACGT", np.uint8), 65536).tobytes(),
        b"tail chunk " * 100,
        b"",
    ]
    results = eng.compress_chunks(chunks, level=1, algorithm="deflate",
                                  huffman_static=False)
    for chunk, (payload, crc) in zip(chunks, results):
        assert crc == (zlib.crc32(chunk) & 0xFFFFFFFF)
        assert zlib.decompressobj(-15).decompress(payload) == chunk


def test_dynamic_engine_path_mesh(monkeypatch):
    """Dynamic two-pass device pack sharded over the full 8-device mesh
    (VERDICT r2 item 3): pass-1 histograms and pass-2 per-row trees both
    shard over ``dp``; every member must stay stock-zlib-exact and the
    batch pad to a mesh-divisible size must not leak into results."""
    from qatzip_tpu import native
    if native.lib is None:
        pytest.skip("native lib unavailable")
    monkeypatch.setenv("QZTPU_DEVICE_PACK", "1")
    import jax
    from qatzip_tpu.parallel.dispatch import DeviceEngine
    devs = jax.devices()
    if len(devs) < 2:
        pytest.skip("needs a multi-device mesh")
    rng = np.random.default_rng(11)
    eng = DeviceEngine(devs, "deflate")
    chunks = [
        (b"mesh dyn engine " * 5000)[:65536],
        rng.choice(np.frombuffer(b"ACGT", np.uint8), 65536).tobytes(),
        rng.integers(0, 256, 65536, dtype=np.uint8).tobytes(),  # stored
        b"short tail " * 50,
        b"",
    ]  # 5 chunks pad to 8 mesh rows
    results = eng.compress_chunks(chunks, level=1, algorithm="deflate",
                                  huffman_static=False)
    for chunk, (payload, crc) in zip(chunks, results):
        assert crc == (zlib.crc32(chunk) & 0xFFFFFFFF)
        assert zlib.decompressobj(-15).decompress(payload) == chunk
