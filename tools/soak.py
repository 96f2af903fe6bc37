"""Randomized cross-surface soak: sessions x formats x levels x sizes,
stream-API random chunk splits, async batches, and stock-tool
cross-checks. The long-running cousin of the unit suite — run it for a
few hundred iterations before a release:

    QZTPU_FORCE_SW=1 JAX_PLATFORMS=cpu python tools/soak.py --iters 300

Every failure dumps the reproducing seed. Mirrors the reference's
hammer-style modes (test/main.c -m 4/17/18) with randomized shapes.
"""
import argparse
import os
import sys
import zlib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("QZTPU_FORCE_SW", "1")

import numpy as np  # noqa: E402

import qatzip_tpu as qz  # noqa: E402
from qatzip_tpu import params as P  # noqa: E402
from qatzip_tpu.constants import DataFormat  # noqa: E402


def corpus(rng, n, kind):
    if kind == 0:
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == 1:
        return rng.choice(np.frombuffer(b"ACGT", np.uint8), n).tobytes()
    if kind == 2:
        base = rng.integers(32, 127, max(n // 17, 1),
                            dtype=np.uint8).tobytes()
        return (base * 40)[:n]
    if kind == 3:
        return bytes(n)
    words = [b"the ", b"of ", b"gpu ", b'<row id="%d"/>' % int(n), b"\n"]
    return b"".join(words[int(i) % 5]
                    for i in rng.integers(0, 5, max(n // 3, 1)))[:n]


def check_deflate(rng, data, level, fmt):
    s = qz.QzSession()
    p = P.get_defaults("deflate")
    p.comp_lvl = level
    p.data_fmt = fmt
    hw = int(rng.choice([4096, 16384, 65536, 131072]))
    p.hw_buff_sz = hw
    s.setup_deflate(p)
    blob = s.compress(data)
    assert s.decompress(blob) == data, "self round-trip"
    if fmt in (DataFormat.DEFLATE_GZIP_EXT, DataFormat.DEFLATE_GZIP):
        # stock multi-member decode
        pos, pieces = 0, []
        while pos < len(blob):
            do = zlib.decompressobj(31)
            pieces.append(do.decompress(blob[pos:]) + do.flush())
            rem = len(do.unused_data)
            if rem == 0:
                break
            pos = len(blob) - rem
        assert b"".join(pieces) == data, "stock zlib decode"
    elif fmt == DataFormat.DEFLATE_RAW:
        do = zlib.decompressobj(-15)
        assert do.decompress(blob) + do.flush() == data


def check_stream(rng, data):
    s = qz.QzSession()
    s.setup_deflate()
    strm = qz.QzStream(s)
    out = b""
    pos = 0
    while pos < len(data):
        step = int(rng.integers(1, 200000))
        piece = data[pos:pos + step]
        pos += len(piece)
        out += strm.compress(piece, last=(pos >= len(data)))
    if not data:
        out += strm.compress(b"", last=True)
    strm.end()
    assert s.decompress(out) == data, "stream round-trip"


def check_lz4(rng, data):
    s = qz.QzSession()
    s.setup_lz4(P.get_defaults("lz4"))
    blob = s.compress(data)
    assert s.decompress(blob) == data, "lz4 round-trip"


def check_async(rng, datas):
    import threading
    import time

    qz.aqz_init(num_threads=2)
    results = {}
    done = threading.Event()
    remaining = [len(datas)]

    def cb(i):
        def _cb(ext, src, dest, rc, crc):
            results[i] = bytes(dest)
            remaining[0] -= 1
            if remaining[0] == 0:
                done.set()
        return _cb

    try:
        sess = qz.AQzSession()
        sess.setup_deflate()
        for i, d in enumerate(datas):
            while sess.compress(d, callback=cb(i)) != 0:
                time.sleep(0.001)        # AQZ_NO_SPACE: ring full, retry
        assert done.wait(timeout=120), "async completion timeout"
    finally:
        qz.aqz_stop()
    dec = qz.QzSession()
    dec.setup_deflate()
    for i, d in enumerate(datas):
        assert dec.decompress(results[i]) == d, f"async req {i}"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    master = np.random.default_rng(args.seed)
    fmts = [DataFormat.DEFLATE_GZIP_EXT, DataFormat.DEFLATE_GZIP,
            DataFormat.DEFLATE_RAW, DataFormat.DEFLATE_4B]
    for it in range(args.iters):
        seed = int(master.integers(0, 2**31))
        rng = np.random.default_rng(seed)
        n = int(rng.integers(0, 800000))
        kind = int(rng.integers(0, 5))
        data = corpus(rng, n, kind)
        surface = it % 4
        try:
            if surface == 0:
                check_deflate(rng, data, int(rng.integers(1, 10)),
                              fmts[int(rng.integers(0, len(fmts)))])
            elif surface == 1:
                check_stream(rng, data)
            elif surface == 2:
                check_lz4(rng, data)
            else:
                datas = [corpus(rng, int(rng.integers(0, 150000)),
                                int(rng.integers(0, 5)))
                         for _ in range(int(rng.integers(1, 6)))]
                check_async(rng, datas)
        except Exception:
            print(f"FAIL iter={it} surface={surface} seed={seed} "
                  f"n={n} kind={kind}", file=sys.stderr)
            raise
        if (it + 1) % 25 == 0:
            print(f"{it + 1}/{args.iters} ok")
    print("soak: all clear")


if __name__ == "__main__":
    main()
