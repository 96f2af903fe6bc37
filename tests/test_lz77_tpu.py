"""Device LZ77 pipeline + accelerated engine tests.

Mirrors the reference's HW/SW-equivalence strategy (test/main.c -m 17
qzFuncTests): accelerated-path output must decode with stock zlib / the SW
codec, and SW output must decode through the accelerated session.
"""

import zlib

import numpy as np
import pytest

import jax.numpy as jnp

from qatzip_tpu.ops.lz77 import (lz77_tokenize, tokens_to_bytes,
                                  merge_segment_tokens)
from qatzip_tpu import native


def _batchify(chunks, n):
    data = np.zeros((len(chunks), n), np.uint8)
    lengths = np.zeros(len(chunks), np.int32)
    for i, c in enumerate(chunks):
        a = np.frombuffer(c, np.uint8)
        data[i, : len(a)] = a
        lengths[i] = len(a)
    return jnp.asarray(data), jnp.asarray(lengths)


N = 4096


@pytest.fixture(scope="module")
def sample_chunks():
    rng = np.random.default_rng(3)
    text = (b"the quick brown fox jumps over the lazy dog. " * 200)[:N]
    return [
        text,
        rng.integers(0, 256, N, dtype=np.uint8).tobytes(),
        b"\x00" * N,
        (b"abcdefgh" * (N // 8)),
        b"short input",
        b"",
        bytes(rng.integers(0, 4, N, dtype=np.uint8) + ord("A")),
    ]


@pytest.fixture(scope="module")
def tokenized(sample_chunks):
    data, lengths = _batchify(sample_chunks, N)
    toks, ntok = lz77_tokenize(data, lengths, n=N)
    return np.asarray(toks), np.asarray(ntok)


def _merged(toks, ntok, i):
    m = merge_segment_tokens(toks[i], ntok[i], parse_seg=8192)
    return m, len(m)


def test_token_roundtrip(sample_chunks, tokenized):
    toks, ntok = tokenized
    for i, c in enumerate(sample_chunks):
        m, nm = _merged(toks, ntok, i)
        assert tokens_to_bytes(m, nm, c) == c


def test_deflate_pack_roundtrip_and_ratio(sample_chunks, tokenized):
    if native.lib is None:
        pytest.skip("native lib unavailable")
    toks, ntok = tokenized
    total_ours = total_zlib = 0
    for i, c in enumerate(sample_chunks):
        m, nm = _merged(toks, ntok, i)
        payload = native.lib.deflate_pack(c, m, nm, final=True, mode=0)
        assert zlib.decompressobj(-15).decompress(payload) == c
        total_ours += len(payload)
        total_zlib += max(len(zlib.compress(c, 1)) - 6, 1)
    # ratio must beat the reference SW path (zlib L1) in aggregate
    assert total_ours <= total_zlib


def test_deflate_pack_static_mode(sample_chunks, tokenized):
    if native.lib is None:
        pytest.skip("native lib unavailable")
    toks, ntok = tokenized
    for i, c in enumerate(sample_chunks):
        m, nm = _merged(toks, ntok, i)
        payload = native.lib.deflate_pack(c, m, nm, final=True, mode=1)
        assert zlib.decompressobj(-15).decompress(payload) == c


def test_deflate_nonfinal_sync_flush(sample_chunks, tokenized):
    """Non-final chunks byte-align with an empty stored block so members
    concatenate into one valid raw stream (FLUSH_FULL analog)."""
    if native.lib is None:
        pytest.skip("native lib unavailable")
    toks, ntok = tokenized
    c0, c1 = sample_chunks[0], sample_chunks[3]
    m0, nm0 = _merged(toks, ntok, 0)
    m3, nm3 = _merged(toks, ntok, 3)
    p0 = native.lib.deflate_pack(c0, m0, nm0, final=False)
    p1 = native.lib.deflate_pack(c1, m3, nm3, final=True)
    assert zlib.decompressobj(-15).decompress(p0 + p1) == c0 + c1


def test_lz4_pack_roundtrip(sample_chunks, tokenized):
    if native.lib is None:
        pytest.skip("native lib unavailable")
    toks, ntok = tokenized
    for i, c in enumerate(sample_chunks):
        m, nm = _merged(toks, ntok, i)
        blk = native.lib.lz4_pack(c, m, nm)
        assert native.lib.lz4_decompress_block(blk, len(c)) == c


def test_lz4s_pack_roundtrip(sample_chunks, tokenized):
    if native.lib is None:
        pytest.skip("native lib unavailable")
    toks, ntok = tokenized
    for i, c in enumerate(sample_chunks):
        for mm in (3, 4):
            m, nm = _merged(toks, ntok, i)
            blk = native.lib.lz4s_pack(c, m, nm, mm)
            ll, ml, oo = native.lib.lz4s_decode_block(blk, mm)
            out = bytearray()
            pos = 0
            for l, m, o in zip(ll.tolist(), ml.tolist(), oo.tolist()):
                out += c[pos:pos + l]
                pos += l
                if m:
                    st = len(out) - o
                    for k in range(m):
                        out.append(out[st + k])
                    pos += m
            assert bytes(out) == c


def test_tpu_engine_session_end_to_end(sample_chunks):
    """Full session through the accelerated engine (device = test CPU mesh
    chip; same code path as the GPU)."""
    from qatzip_tpu import QzSession, params as P
    from qatzip_tpu.parallel.dispatch import DeviceEngine
    import jax

    blob = b"".join(sample_chunks) * 3
    sess = QzSession()
    sess.setup_deflate(P.get_defaults("deflate"))
    sess._engine = DeviceEngine(jax.devices(), "deflate")
    out = sess.compress(blob)
    # decode via stock zlib (multi-member gzip)
    pieces, pos = [], 0
    while pos < len(out):
        do = zlib.decompressobj(31)
        pieces.append(do.decompress(out[pos:]) + do.flush())
        consumed = len(out) - pos - len(do.unused_data)
        assert consumed > 0
        pos += consumed
    assert b"".join(pieces) == blob
    # decode via framework
    assert sess.decompress(out) == blob


def test_tpu_engine_lz4_session(sample_chunks):
    from qatzip_tpu import QzSession, params as P
    from qatzip_tpu.parallel.dispatch import DeviceEngine
    import jax

    blob = b"".join(sample_chunks)
    sess = QzSession()
    sess.setup_lz4(P.get_defaults("lz4"))
    sess._engine = DeviceEngine(jax.devices(), "lz4")
    out = sess.compress(blob)
    dsess = QzSession()
    dsess.setup_lz4(P.get_defaults("lz4"))
    assert dsess.decompress(out) == blob


def test_engine_cnv_verify(sample_chunks):
    """CnV decode-verify accepts valid payloads (fallback untriggered)."""
    from qatzip_tpu.parallel.dispatch import DeviceEngine
    import jax

    eng = DeviceEngine(jax.devices(), "deflate")
    res = eng.compress_chunks(sample_chunks, level=1, algorithm="deflate",
                              cnv=True)
    for (payload, crc), c in zip(res, sample_chunks):
        assert zlib.decompressobj(-15).decompress(payload) == c
        assert crc == (zlib.crc32(c) & 0xFFFFFFFF)


def test_mesh_tokenize_8dev():
    """Chunk-DP sharding over the 8-device test mesh."""
    from qatzip_tpu.parallel.mesh import make_mesh, mesh_tokenize
    import jax

    mesh = make_mesh(jax.devices())
    b = len(jax.devices()) * 2
    n = 1024
    rng = np.random.default_rng(0)
    rows = [(b"mesh row %d " % i) * 80 for i in range(b)]
    data = np.zeros((b, n), np.uint8)
    lengths = np.zeros(b, np.int32)
    for i, r in enumerate(rows):
        a = np.frombuffer(r[:n], np.uint8)
        data[i, : len(a)] = a
        lengths[i] = len(a)
    toks, ntok, stats = mesh_tokenize(mesh, data, lengths, n=n)
    assert int(stats[1]) == int(lengths.sum())
    for i in range(b):
        m = merge_segment_tokens(toks[i], ntok[i], parse_seg=8192)
        assert tokens_to_bytes(m, len(m), rows[i][:n]) == rows[i][:n]


def test_graft_entry():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    toks, ntok = fn(*args)
    assert toks.shape[0] == args[0].shape[0]
    ge.dryrun_multichip(8)


def test_device_lz4_decode_leg(monkeypatch):
    """The device LZ4 decode leg (host ref-plane parse + device pointer
    doubling) decodes stock-format LZ4 blocks byte-exact, and the engine
    router uses it under QZTPU_DEVICE_DECODE=1."""
    import os as _os
    import numpy as _np
    from qatzip_tpu import native
    if native.lib is None:
        import pytest
        pytest.skip("native lib unavailable")
    from qatzip_tpu.ops.lz4_decode import decode_blocks_device

    rng = _np.random.default_rng(9)
    rows = [
        b"compress me please " * 300,
        rng.integers(0, 256, 5000, dtype=_np.uint8).tobytes(),
        b"A" * 20000,                      # deep RLE chains (dist 1)
        (b"abc" * 5000 + b"xyz" * 100),
        b"x",
    ]
    payloads = [native.lib.lz4_compress_block(r) for r in rows]
    out = decode_blocks_device(payloads, [len(r) for r in rows])
    for got, want in zip(out, rows):
        assert got == want

    # router honors the env switch end-to-end through the LZ4 frame path
    monkeypatch.setenv("QZTPU_DEVICE_DECODE", "1")
    import qatzip_tpu as qz
    s = qz.QzSession()
    s.setup_lz4()
    data = b"frame level lz4 " * 4000
    blob = s.compress(data)
    s2 = qz.QzSession()
    s2.setup_lz4()
    assert s2.decompress(blob) == data


def test_device_lz4_decode_deep_chain():
    """Copy chains deeper than 2^17 must resolve (regression: rounds were
    capped at 17 regardless of block size, silently corrupting output)."""
    from qatzip_tpu import native
    if native.lib is None:
        import pytest
        pytest.skip("native lib unavailable")
    from qatzip_tpu.ops.lz4_decode import decode_blocks_device
    data = b"Z" * 300001                  # dist-1 RLE chain of depth 300K
    payload = native.lib.lz4_compress_block(data)
    (out,) = decode_blocks_device([payload], [len(data)])
    assert out == data


def test_segmented_search_roundtrip(sample_chunks):
    """search_seg windows the candidate-search sorts (speed knob); tokens
    must still decode exactly, and compressible inputs must still find
    matches (the 1KB overlap keeps short-distance matches alive across
    window boundaries)."""
    data, lengths = _batchify(sample_chunks, N)
    toks, ntok = lz77_tokenize(data, lengths, n=N, search_seg=1024,
                               search_overlap=256)
    toks, ntok = np.asarray(toks), np.asarray(ntok)
    for i, c in enumerate(sample_chunks):
        m = merge_segment_tokens(toks[i], ntok[i], parse_seg=8192)
        assert tokens_to_bytes(m, len(m), c) == c
    # highly repetitive rows must still compress hard despite windowing
    assert ntok[2] <= 24          # all-zeros row
    assert ntok[3] <= 60          # 8-byte period row


def test_segmented_compaction_roundtrip(sample_chunks):
    """compact_seg compacts tokens to segment prefixes; ntok becomes
    (B, n/cs) and merge_segment_tokens stitches the stream back."""
    cs = 1024
    data, lengths = _batchify(sample_chunks, N)
    toks, ntok = lz77_tokenize(data, lengths, n=N, compact_seg=cs)
    toks, ntok = np.asarray(toks), np.asarray(ntok)
    assert ntok.shape == (len(sample_chunks), N // cs)
    ref_toks, ref_ntok = lz77_tokenize(data, lengths, n=N)
    ref_toks, ref_ntok = np.asarray(ref_toks), np.asarray(ref_ntok)
    for i, c in enumerate(sample_chunks):
        m = merge_segment_tokens(toks[i], ntok[i], parse_seg=cs)
        # identical token stream to the unsegmented compaction
        assert np.array_equal(m, ref_toks[i][: ref_ntok[i]])
        assert tokens_to_bytes(m, len(m), c) == c


def test_stride2_search_roundtrip(sample_chunks):
    """Half-lattice (search_stride=2) candidate search decodes exactly.

    The formulation is measured-and-rejected as the L1 default (−13.6%
    ratio, see ops/lz77.py docstring) but stays available; this pins its
    correctness so the priced data point remains reproducible."""
    data, lengths = _batchify(sample_chunks, N)
    toks, ntok = lz77_tokenize(data, lengths, n=N, search_seg=2048,
                               search_overlap=512, search_stride=2)
    toks, ntok = np.asarray(toks), np.asarray(ntok)
    for i, chunk in enumerate(sample_chunks):
        m = merge_segment_tokens(toks[i], ntok[i], parse_seg=8192)
        assert tokens_to_bytes(m, len(m), chunk) == chunk
