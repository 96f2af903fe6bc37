// qztpu_native — host-side native runtime for the accelerated QATzip rebuild.
//
// Provides the byte-serial pieces that stay on the host CPU:
//   * xxh32 (LZ4 frame checksums; analog of the reference's vendored xxhash,
//     src/xxhash.c)
//   * LZ4 block compress/decompress (analog of the software fallback path
//     src/qatzip_sw.c:430-628, re-implemented from the LZ4 format spec)
//   * LZ4s block compress/decode-to-sequences (analog of the QAT LZ4s output
//     consumed by utils/qzstd.c:117-180)
//   * lz4s -> zstd post-process bridge (ZSTD_compressSequences, analog of
//     utils/qzstd.c:211-278); compiled only where <zstd.h> exists, else
//     every qz_zstd_* entry point returns QZ_ZSTD_UNAVAILABLE
//   * DEFLATE static/dynamic-Huffman bit-packing from token arrays (host leg
//     of the hybrid device pipeline; also the CPU reference for the
//     on-device bitpacker)
//
// Exposed as a plain C ABI for ctypes. All functions are thread-safe and
// GIL-free (no Python API usage).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <memory>
#include <thread>
#include <vector>

#if __has_include(<zstd.h>)
#define QZ_HAVE_ZSTD 1
#define ZSTD_STATIC_LINKING_ONLY 1
#include <zstd.h>
#include <zstd_errors.h>
#else
#define QZ_HAVE_ZSTD 0
#endif

extern "C" {

// ---------------------------------------------------------------------------
// XXH32
// ---------------------------------------------------------------------------
static inline uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

static const uint32_t XP1 = 0x9E3779B1u, XP2 = 0x85EBCA77u, XP3 = 0xC2B2AE3Du,
                      XP4 = 0x27D4EB2Fu, XP5 = 0x165667B1u;

static inline uint32_t xread32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;  // little-endian hosts only (x86/ARM LE)
}

uint32_t qz_xxh32(const uint8_t* data, uint64_t len, uint32_t seed) {
  const uint8_t* p = data;
  const uint8_t* end = data + len;
  uint32_t h;
  if (len >= 16) {
    uint32_t a1 = seed + XP1 + XP2, a2 = seed + XP2, a3 = seed, a4 = seed - XP1;
    const uint8_t* limit = end - 16;
    do {
      a1 = rotl32(a1 + xread32(p) * XP2, 13) * XP1; p += 4;
      a2 = rotl32(a2 + xread32(p) * XP2, 13) * XP1; p += 4;
      a3 = rotl32(a3 + xread32(p) * XP2, 13) * XP1; p += 4;
      a4 = rotl32(a4 + xread32(p) * XP2, 13) * XP1; p += 4;
    } while (p <= limit);
    h = rotl32(a1, 1) + rotl32(a2, 7) + rotl32(a3, 12) + rotl32(a4, 18);
  } else {
    h = seed + XP5;
  }
  h += (uint32_t)len;
  while (p + 4 <= end) {
    h = rotl32(h + xread32(p) * XP3, 17) * XP4;
    p += 4;
  }
  while (p < end) {
    h = rotl32(h + (*p) * XP5, 11) * XP1;
    ++p;
  }
  h ^= h >> 15; h *= XP2; h ^= h >> 13; h *= XP3; h ^= h >> 16;
  return h;
}

// ---------------------------------------------------------------------------
// CRC64 — configurable polynomial, slicing-by-8 (the data-path-speed engine
// behind the v2.3 CRC64 API; the reference declares but never implements it,
// include/qatzip.h:742-753)
// ---------------------------------------------------------------------------

// qz_crc64_tables fills tbl[8*256] for (poly, reflect_in). Stateless so the
// Python side caches tables per config.
void qz_crc64_tables(uint64_t poly, int32_t reflected, uint64_t* tbl) {
  if (reflected) {
    uint64_t rp = 0;  // bit-reverse the polynomial
    for (int i = 0; i < 64; ++i) rp |= ((poly >> i) & 1u) << (63 - i);
    for (uint32_t i = 0; i < 256; ++i) {
      uint64_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (rp & (~((c & 1) - 1)));
      tbl[i] = c;
    }
    for (int t = 1; t < 8; ++t)
      for (uint32_t i = 0; i < 256; ++i)
        tbl[t * 256 + i] =
            (tbl[(t - 1) * 256 + i] >> 8) ^ tbl[tbl[(t - 1) * 256 + i] & 0xFF];
  } else {
    for (uint32_t i = 0; i < 256; ++i) {
      uint64_t c = (uint64_t)i << 56;
      for (int k = 0; k < 8; ++k)
        c = (c << 1) ^ (poly & (~(((c >> 63) & 1) - 1)));
      tbl[i] = c;
    }
    for (int t = 1; t < 8; ++t)
      for (uint32_t i = 0; i < 256; ++i)
        tbl[t * 256 + i] = (tbl[(t - 1) * 256 + i] << 8) ^
                           tbl[(tbl[(t - 1) * 256 + i] >> 56) & 0xFF];
  }
}

uint64_t qz_crc64(const uint8_t* data, int64_t n, const uint64_t* tbl,
                  uint64_t crc, int32_t reflected) {
  const uint8_t* p = data;
  if (reflected) {
    while (n >= 8) {
      uint64_t w;
      std::memcpy(&w, p, 8);
      w ^= crc;
      crc = tbl[7 * 256 + (w & 0xFF)] ^ tbl[6 * 256 + ((w >> 8) & 0xFF)] ^
            tbl[5 * 256 + ((w >> 16) & 0xFF)] ^
            tbl[4 * 256 + ((w >> 24) & 0xFF)] ^
            tbl[3 * 256 + ((w >> 32) & 0xFF)] ^
            tbl[2 * 256 + ((w >> 40) & 0xFF)] ^
            tbl[1 * 256 + ((w >> 48) & 0xFF)] ^ tbl[(w >> 56) & 0xFF];
      p += 8;
      n -= 8;
    }
    while (n-- > 0) crc = (crc >> 8) ^ tbl[(crc ^ *p++) & 0xFF];
  } else {
    while (n >= 8) {
      // big-endian polynomial order: byte i pairs with table 7-i
      crc ^= ((uint64_t)p[0] << 56) | ((uint64_t)p[1] << 48) |
             ((uint64_t)p[2] << 40) | ((uint64_t)p[3] << 32) |
             ((uint64_t)p[4] << 24) | ((uint64_t)p[5] << 16) |
             ((uint64_t)p[6] << 8) | (uint64_t)p[7];
      crc = tbl[7 * 256 + ((crc >> 56) & 0xFF)] ^
            tbl[6 * 256 + ((crc >> 48) & 0xFF)] ^
            tbl[5 * 256 + ((crc >> 40) & 0xFF)] ^
            tbl[4 * 256 + ((crc >> 32) & 0xFF)] ^
            tbl[3 * 256 + ((crc >> 24) & 0xFF)] ^
            tbl[2 * 256 + ((crc >> 16) & 0xFF)] ^
            tbl[1 * 256 + ((crc >> 8) & 0xFF)] ^ tbl[crc & 0xFF];
      p += 8;
      n -= 8;
    }
    while (n-- > 0) crc = (crc << 8) ^ tbl[((crc >> 56) ^ *p++) & 0xFF];
  }
  return crc;
}

// ---------------------------------------------------------------------------
// LZ4 block codec (format per the public LZ4 block spec)
// ---------------------------------------------------------------------------
static const int LZ4_MINMATCH = 4;
static const int LZ4_MFLIMIT = 12;     // last match must start 12B before end
static const int LZ4_LASTLITERALS = 5; // last 5 bytes always literals
static const int LZ4_HASH_LOG = 14;

static inline uint32_t lz4_hash(uint32_t v) {
  return (v * 2654435761u) >> (32 - LZ4_HASH_LOG);
}

// Emit one sequence; returns new op or NULL on overflow.
static uint8_t* lz4_emit(uint8_t* op, uint8_t* oend, const uint8_t* lit,
                         size_t lit_len, size_t match_len_m4, uint16_t offset,
                         bool has_match) {
  // token + litlen extension
  size_t need = 1 + lit_len / 255 + 1 + lit_len + (has_match ? 2 + 1 + match_len_m4 / 255 : 0);
  if (op + need + 8 > oend) return nullptr;
  uint8_t* tok = op++;
  if (lit_len >= 15) {
    *tok = (uint8_t)(15 << 4);
    size_t r = lit_len - 15;
    while (r >= 255) { *op++ = 255; r -= 255; }
    *op++ = (uint8_t)r;
  } else {
    *tok = (uint8_t)(lit_len << 4);
  }
  std::memcpy(op, lit, lit_len);
  op += lit_len;
  if (has_match) {
    op[0] = (uint8_t)(offset & 0xFF);
    op[1] = (uint8_t)(offset >> 8);
    op += 2;
    if (match_len_m4 >= 15) {
      *tok |= 15;
      size_t r = match_len_m4 - 15;
      while (r >= 255) { *op++ = 255; r -= 255; }
      *op++ = (uint8_t)r;
    } else {
      *tok |= (uint8_t)match_len_m4;
    }
  }
  return op;
}

// Greedy LZ4 block compressor. max_distance bounds offsets (the accelerated
// path uses 32KB history, reference src/qatzip_utils.c:270). Returns
// compressed size, or 0 if dst too small / incompressible beyond cap.
int64_t qz_lz4_compress_block(const uint8_t* src, int64_t n, uint8_t* dst,
                              int64_t cap, int32_t max_distance) {
  if (n < 0 || cap <= 0) return -1;
  uint8_t* op = dst;
  uint8_t* oend = dst + cap;
  if (n == 0) {
    if (cap < 1) return 0;
    *op = 0;  // single empty-literal token
    return 1;
  }
  // table stores pos+1 (0 = empty); works for blocks <= 64KB. Larger
  // blocks use the 32-bit thread-local table.
  const bool small = n <= 65535;
  uint16_t table[1 << LZ4_HASH_LOG];
  if (small) std::memset(table, 0, sizeof(table));
  static thread_local uint32_t big_table[1 << LZ4_HASH_LOG];
  if (!small) std::memset(big_table, 0xFF, sizeof(big_table));

  const uint8_t* ip = src;
  const uint8_t* iend = src + n;
  const uint8_t* anchor = src;
  const uint8_t* mflimit = iend - LZ4_MFLIMIT;

  if (n >= LZ4_MFLIMIT + 1) {
    while (ip < mflimit) {
      uint32_t seq = xread32(ip);
      uint32_t h = lz4_hash(seq);
      const uint8_t* match = nullptr;
      if (small) {
        uint16_t prev = table[h];
        table[h] = (uint16_t)(ip - src + 1);
        if (prev) match = src + prev - 1;
      } else {
        uint32_t prev = big_table[h];
        big_table[h] = (uint32_t)(ip - src);
        if (prev != 0xFFFFFFFFu) match = src + prev;
      }
      if (match && match < ip && (ip - match) <= max_distance &&
          xread32(match) == seq) {
        // extend forward
        const uint8_t* m = match + LZ4_MINMATCH;
        const uint8_t* i2 = ip + LZ4_MINMATCH;
        const uint8_t* ilimit = iend - LZ4_LASTLITERALS;
        while (i2 < ilimit && *i2 == *m) { ++i2; ++m; }
        size_t mlen = (size_t)(i2 - ip);
        uint16_t off = (uint16_t)(ip - match);
        op = lz4_emit(op, oend, anchor, (size_t)(ip - anchor),
                      mlen - LZ4_MINMATCH, off, true);
        if (!op) return 0;
        ip = i2;
        anchor = ip;
      } else {
        ++ip;
      }
    }
  }
  // final literals
  op = lz4_emit(op, oend, anchor, (size_t)(iend - anchor), 0, 0, false);
  if (!op) return 0;
  return (int64_t)(op - dst);
}

// LZ4 block decompressor with full bounds checking. Returns decompressed
// size, or -1 on malformed input.
int64_t qz_lz4_decompress_block(const uint8_t* src, int64_t n, uint8_t* dst,
                                int64_t cap) {
  const uint8_t* ip = src;
  const uint8_t* iend = src + n;
  uint8_t* op = dst;
  uint8_t* oend = dst + cap;
  while (ip < iend) {
    uint32_t token = *ip++;
    // literals
    size_t lit = token >> 4;
    if (lit == 15) {
      uint8_t s;
      do {
        if (ip >= iend) return -1;
        s = *ip++;
        lit += s;
      } while (s == 255);
    }
    if (ip + lit > iend || op + lit > oend) return -1;
    std::memcpy(op, ip, lit);
    ip += lit;
    op += lit;
    if (ip >= iend) break;  // last sequence has no match
    // match
    if (ip + 2 > iend) return -1;
    uint32_t offset = ip[0] | ((uint32_t)ip[1] << 8);
    ip += 2;
    if (offset == 0 || (int64_t)offset > op - dst) return -1;
    size_t mlen = token & 15;
    if (mlen == 15) {
      uint8_t s;
      do {
        if (ip >= iend) return -1;
        s = *ip++;
        mlen += s;
      } while (s == 255);
    }
    mlen += LZ4_MINMATCH;
    if (op + mlen > oend) return -1;
    const uint8_t* m = op - offset;
    // wide overlap-safe copy (same tiers as the inflate's copy_match):
    // RLE memset, 16-byte stamps for non-overlapping copies, seed-then-
    // double for short periods; byte loop only near the buffer tail
    if (offset == 1) {
      std::memset(op, m[0], mlen);
    } else if (op + mlen + 16 <= oend
               && (offset >= 16 || (size_t)offset >= mlen)) {
      uint8_t* o = op;
      const uint8_t* s = m;
      int64_t k = (int64_t)mlen;
      do {
        uint64_t a0, a1;
        std::memcpy(&a0, s, 8);
        std::memcpy(&a1, s + 8, 8);
        std::memcpy(o, &a0, 8);
        std::memcpy(o + 8, &a1, 8);
        o += 16;
        s += 16;
        k -= 16;
      } while (k > 0);
    } else if (op + mlen + 16 <= oend) {
      for (size_t k = 0; k < offset && k < mlen; ++k) op[k] = m[k];
      size_t have = offset;
      while (have < mlen) {
        size_t c = mlen - have < have ? mlen - have : have;
        std::memcpy(op + have, op, c);
        have += c;
      }
    } else {
      for (size_t k = 0; k < mlen; ++k) op[k] = m[k];
    }
    op += mlen;
  }
  return (int64_t)(op - dst);
}

// ---------------------------------------------------------------------------
// LZ4s block codec
//
// Token format observed by utils/qzstd.c:117-180: LZ4-style token, but the
// stored match length is (len - (mini_match - 1)) and 0 means "no match"
// (a literal-only sequence that still carries a 2-byte offset field unless
// it terminates the block).
// ---------------------------------------------------------------------------
int64_t qz_lz4s_compress_block(const uint8_t* src, int64_t n, uint8_t* dst,
                               int64_t cap, int32_t mini_match,
                               int32_t max_distance) {
  if (mini_match != 3 && mini_match != 4) return -1;
  const uint32_t min_stored_base = (uint32_t)(mini_match - 1);
  uint8_t* op = dst;
  uint8_t* oend = dst + cap;
  if (n == 0) {
    if (cap < 1) return 0;
    *op = 0;
    return 1;
  }
  uint16_t table[1 << LZ4_HASH_LOG];
  std::memset(table, 0, sizeof(table));
  const uint8_t* ip = src;
  const uint8_t* iend = src + n;
  const uint8_t* anchor = src;
  const uint8_t* mflimit = (n > LZ4_MFLIMIT) ? iend - LZ4_MFLIMIT : src;

  while (ip < mflimit) {
    uint32_t seq = xread32(ip);
    uint32_t h = lz4_hash(seq);
    uint16_t prev = table[h];
    table[h] = (uint16_t)(ip - src + 1);
    const uint8_t* match = prev ? src + prev - 1 : nullptr;
    bool ok = false;
    size_t mlen = 0;
    if (match && match < ip && (ip - match) <= max_distance) {
      // need at least mini_match equal bytes
      if (mini_match == 4) {
        ok = xread32(match) == seq;
        mlen = 4;
      } else {
        ok = (match[0] == ip[0] && match[1] == ip[1] && match[2] == ip[2]);
        mlen = 3;
      }
    }
    if (ok) {
      const uint8_t* m = match + mlen;
      const uint8_t* i2 = ip + mlen;
      const uint8_t* ilimit = iend - LZ4_LASTLITERALS;
      while (i2 < ilimit && *i2 == *m) { ++i2; ++m; }
      mlen = (size_t)(i2 - ip);
      size_t lit = (size_t)(ip - anchor);
      size_t stored = mlen - min_stored_base;
      size_t need = 1 + lit / 255 + 1 + lit + 2 + 1 + stored / 255;
      if (op + need + 8 > oend) return 0;
      uint8_t* tok = op++;
      if (lit >= 15) {
        *tok = (uint8_t)(15 << 4);
        size_t r = lit - 15;
        while (r >= 255) { *op++ = 255; r -= 255; }
        *op++ = (uint8_t)r;
      } else {
        *tok = (uint8_t)(lit << 4);
      }
      std::memcpy(op, anchor, lit);
      op += lit;
      uint16_t off = (uint16_t)(ip - match);
      op[0] = (uint8_t)(off & 0xFF);
      op[1] = (uint8_t)(off >> 8);
      op += 2;
      if (stored >= 15) {
        *tok |= 15;
        size_t r = stored - 15;
        while (r >= 255) { *op++ = 255; r -= 255; }
        *op++ = (uint8_t)r;
      } else {
        *tok |= (uint8_t)stored;
      }
      ip += mlen;
      anchor = ip;
    } else {
      ++ip;
    }
  }
  // trailing literal-only sequence (no offset — terminates block)
  op = lz4_emit(op, oend, anchor, (size_t)(iend - anchor), 0, 0, false);
  if (!op) return 0;
  return (int64_t)(op - dst);
}

// Decode an LZ4s block into (litlen, matchlen, offset) triples. Mirrors
// decLz4Block (utils/qzstd.c:117-180) including the litLength accumulation
// across matchless sequences. Returns the number of triples written, with
// the final triple potentially match-less (matchlen 0). Returns -1 on
// malformed input or overflow of the output arrays.
int64_t qz_lz4s_decode_block(const uint8_t* src, int64_t n,
                             int32_t mini_match, uint32_t* litlens,
                             uint32_t* matchlens, uint32_t* offsets,
                             int64_t seq_cap) {
  const uint32_t add = (uint32_t)(mini_match - 1);
  const uint8_t* ip = src;
  const uint8_t* iend = src + n;
  int64_t ns = 0;
  uint32_t pend_lit = 0;
  while (ip < iend) {
    uint32_t token = *ip++;
    size_t lit = token >> 4;
    if (lit == 15) {
      uint8_t s;
      do {
        if (ip >= iend) return -1;
        s = *ip++;
        lit += s;
      } while (s == 255);
    }
    if (ip + lit > iend) return -1;
    pend_lit += (uint32_t)lit;
    ip += lit;
    if (ip >= iend) break;  // block ends with literals
    if (ip + 2 > iend) return -1;
    uint32_t off = ip[0] | ((uint32_t)ip[1] << 8);
    ip += 2;
    size_t ml = token & 15;
    if (ml == 15) {
      uint8_t s;
      do {
        if (ip >= iend) return -1;
        s = *ip++;
        ml += s;
      } while (s == 255);
    }
    if (ml != 0) {
      if (off == 0) return -1;  // real matches need a backward distance
      if (ns >= seq_cap) return -1;
      litlens[ns] = pend_lit;
      matchlens[ns] = (uint32_t)ml + add;
      offsets[ns] = off;
      ++ns;
      pend_lit = 0;
    }
    // ml == 0: literal-only sequence; literals accumulate into the next
  }
  // trailing literals entry (also used as zstd block delimiter)
  if (ns >= seq_cap) return -1;
  litlens[ns] = pend_lit;
  matchlens[ns] = 0;
  offsets[ns] = 0;
  ++ns;
  return ns;
}

// ---------------------------------------------------------------------------
// lz4s -> zstd post-process (analog of zstdCallBack, utils/qzstd.c:211-278)
//
// lz4s_buf holds [blk_size:u32][lz4s payload]* as produced by the LZ4S
// session; src is the original uncompressed input. Emits standard zstd
// frames into out. Returns bytes written or negative zstd error.
// ---------------------------------------------------------------------------
#if QZ_HAVE_ZSTD
int32_t qz_have_zstd() { return 1; }

int64_t qz_zstd_post_process(const uint8_t* src, int64_t src_len,
                             const uint8_t* lz4s_buf, int64_t lz4s_len,
                             int32_t mini_match, uint8_t* out,
                             int64_t out_cap, int32_t level) {
  ZSTD_CCtx* zc = ZSTD_createCCtx();
  if (!zc) return -1000;
  ZSTD_CCtx_setParameter(zc, ZSTD_c_blockDelimiters,
                         ZSTD_sf_explicitBlockDelimiters);
  // validate sequences so malformed lz4s input yields an error code
  // instead of a silently undecodable zstd frame
  ZSTD_CCtx_setParameter(zc, ZSTD_c_validateSequences, 1);
  if (level > 0) ZSTD_CCtx_setParameter(zc, ZSTD_c_compressionLevel, level);

  const int64_t SEQ_CAP = 1 << 17;
  ZSTD_Sequence* seqs =
      (ZSTD_Sequence*)std::malloc(sizeof(ZSTD_Sequence) * SEQ_CAP);
  uint32_t* ll = (uint32_t*)std::malloc(4 * SEQ_CAP);
  uint32_t* mm = (uint32_t*)std::malloc(4 * SEQ_CAP);
  uint32_t* oo = (uint32_t*)std::malloc(4 * SEQ_CAP);
  if (!seqs || !ll || !mm || !oo) {
    std::free(seqs); std::free(ll); std::free(mm); std::free(oo);
    ZSTD_freeCCtx(zc);
    return -1001;
  }

  int64_t produced = 0, consumed = 0, pos = 0, rc = 0;
  while (pos + 4 <= lz4s_len) {
    uint32_t blk;
    std::memcpy(&blk, lz4s_buf + pos, 4);
    pos += 4;
    if (pos + blk > (uint64_t)lz4s_len) { rc = -1002; goto done; }
    int64_t ns = qz_lz4s_decode_block(lz4s_buf + pos, blk, mini_match, ll, mm,
                                      oo, SEQ_CAP);
    if (ns < 0) { rc = -1003; goto done; }
    pos += blk;
    uint64_t cnt = 0;
    for (int64_t i = 0; i < ns; ++i) {
      seqs[i].offset = oo[i];
      seqs[i].litLength = ll[i];
      seqs[i].matchLength = mm[i];
      seqs[i].rep = 0;
      cnt += ll[i] + mm[i];
    }
    if (consumed + (int64_t)cnt > src_len) { rc = -1004; goto done; }
    size_t bound = ZSTD_compressBound(cnt);
    if (produced + (int64_t)bound > out_cap) { rc = -1005; goto done; }
    size_t csz = ZSTD_compressSequences(zc, out + produced, bound, seqs,
                                        (size_t)ns, src + consumed, cnt);
    if (ZSTD_isError(csz)) { rc = -(int64_t)ZSTD_getErrorCode(csz) - 2000; goto done; }
    produced += (int64_t)csz;
    consumed += (int64_t)cnt;
  }
  rc = produced;
done:
  std::free(seqs); std::free(ll); std::free(mm); std::free(oo);
  ZSTD_freeCCtx(zc);
  return rc;
}

// Plain zstd helpers for the qzstd CLI small-input path + decompression.
int64_t qz_zstd_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                         int64_t cap, int32_t level) {
  size_t r = ZSTD_compress(dst, cap, src, n, level);
  if (ZSTD_isError(r)) return -(int64_t)ZSTD_getErrorCode(r) - 2000;
  return (int64_t)r;
}

int64_t qz_zstd_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                           int64_t cap) {
  size_t r = ZSTD_decompress(dst, cap, src, n);
  if (ZSTD_isError(r)) return -(int64_t)ZSTD_getErrorCode(r) - 2000;
  return (int64_t)r;
}

uint64_t qz_zstd_compress_bound(uint64_t n) { return ZSTD_compressBound(n); }
#else
// zstd.h absent at build time: the rest of the library still builds; the
// Python wrappers check qz_have_zstd() and raise before calling these.
static const int64_t QZ_ZSTD_UNAVAILABLE = -1999;
int32_t qz_have_zstd() { return 0; }
int64_t qz_zstd_post_process(const uint8_t*, int64_t, const uint8_t*, int64_t,
                             int32_t, uint8_t*, int64_t, int32_t) {
  return QZ_ZSTD_UNAVAILABLE;
}
int64_t qz_zstd_compress(const uint8_t*, int64_t, uint8_t*, int64_t,
                         int32_t) {
  return QZ_ZSTD_UNAVAILABLE;
}
int64_t qz_zstd_decompress(const uint8_t*, int64_t, uint8_t*, int64_t) {
  return QZ_ZSTD_UNAVAILABLE;
}
uint64_t qz_zstd_compress_bound(uint64_t n) { return n + (n >> 7) + 512; }
#endif  // QZ_HAVE_ZSTD

// ---------------------------------------------------------------------------
// DEFLATE static-Huffman bit packing from token arrays.
//
// Tokens: for i in [0, ntok): if len[i] == 0 emit literal lit[i], else emit
// match (len[i] in [3,258], dist[i] in [1,32768]). Emits one deflate block
// with BFINAL=final, BTYPE=01 (static). Returns bytes written (block is
// byte-padded only when pad!=0) or -1 on overflow. bit_offset allows
// continuing a partial byte from a previous call (pass the returned
// bit position).
// ---------------------------------------------------------------------------
struct BitWriter {
  uint8_t* dst;
  int64_t cap;
  int64_t bitpos;
  bool overflow;
  // register accumulator: put() is pure register ops; one 8-byte store
  // lands every ~56 accumulated bits (~6 literal codes) instead of per
  // symbol. Callers that read/steer ``bitpos`` directly (stored-block
  // emit, sync-flush tails, return values) MUST call flush() first —
  // acc bits are not visible in dst or bitpos until then. dst needs NO
  // pre-zeroing: each store zero-pads its window past the valid bits,
  // the next flush starts inside the previous window (nacc <= 56 < 64),
  // and only the partial first byte carries earlier content — so flush
  // reads ONE byte, not the full (possibly virgin) 8-byte window.
  uint64_t acc = 0;
  int nacc = 0;
  void flush() {
    if (!nacc) return;
    if (!overflow) {
      int64_t byte = bitpos >> 3;
      int shift = (int)(bitpos & 7);
      if (byte + 8 > cap) {
        overflow = true;
      } else {
        uint64_t cur = shift ? (uint64_t)(dst[byte] & ((1u << shift) - 1))
                             : 0;
        cur |= acc << shift;           // nacc <= 56, shift <= 7: fits
        std::memcpy(dst + byte, &cur, 8);
        bitpos += nacc;
      }
    }
    acc = 0;
    nacc = 0;
  }
  inline void put(uint32_t value, int nbits) {
    if (nacc + nbits > 56) flush();
    acc |= (uint64_t)value << nacc;
    nacc += nbits;
  }
};

static inline uint32_t bitrev(uint32_t v, int n) {
  uint32_t r = 0;
  for (int i = 0; i < n; ++i) { r = (r << 1) | (v & 1); v >>= 1; }
  return r;
}

// length code tables (RFC1951 §3.2.5)
static const uint16_t LEN_BASE[29] = {3,4,5,6,7,8,9,10,11,13,15,17,19,23,27,31,
                                      35,43,51,59,67,83,99,115,131,163,195,227,258};
static const uint8_t LEN_EXTRA[29] = {0,0,0,0,0,0,0,0,1,1,1,1,2,2,2,2,
                                      3,3,3,3,4,4,4,4,5,5,5,5,0};
static const uint32_t DIST_BASE[30] = {1,2,3,4,5,7,9,13,17,25,33,49,65,97,129,193,
                                       257,385,513,769,1025,1537,2049,3073,4097,6145,
                                       8193,12289,16385,24577};
static const uint8_t DIST_EXTRA[30] = {0,0,0,0,1,1,2,2,3,3,4,4,5,5,6,6,
                                       7,7,8,8,9,9,10,10,11,11,12,12,13,13};

static int len_code_lut[259];
static int dist_code_lut_hi[512];  // for dist > 256: index (dist-1)>>7
static int dist_code_lut_lo[257];  // for dist <= 256
static bool luts_init = false;

static void init_luts();
// Initialize at library load: callers run on GIL-free thread pools, so a
// lazy first-call init would race (two writers, or a reordered flag store
// exposing half-built tables -> silently corrupt streams).
namespace { struct LutInit { LutInit() { init_luts(); } } lut_init_at_load; }

static void init_luts() {
  for (int c = 0; c < 29; ++c) {
    int hi = (c == 28) ? 258 : LEN_BASE[c + 1] - 1;
    for (int l = LEN_BASE[c]; l <= hi && l <= 258; ++l) len_code_lut[l] = c;
  }
  len_code_lut[258] = 28;
  for (int c = 0; c < 30; ++c) {
    int hi = (c == 29) ? 32768 : (int)DIST_BASE[c + 1] - 1;
    for (int d = (int)DIST_BASE[c]; d <= hi && d <= 32768; ++d) {
      if (d <= 256) dist_code_lut_lo[d] = c;
      else {
        int idx = (d - 1) >> 7;
        if (idx < 512) dist_code_lut_hi[idx] = c;
      }
    }
  }
  luts_init = true;
}

static inline int dist_code(int d) {
  return d <= 256 ? dist_code_lut_lo[d] : dist_code_lut_hi[(d - 1) >> 7];
}

// static literal/length Huffman code (RFC1951 §3.2.6), bit-reversed for the
// LSB-first bitstream.
static inline void static_lit_code(int sym, uint32_t* code, int* nbits) {
  if (sym <= 143) { *code = bitrev(0x30 + sym, 8); *nbits = 8; }
  else if (sym <= 255) { *code = bitrev(0x190 + (sym - 144), 9); *nbits = 9; }
  else if (sym <= 279) { *code = bitrev(sym - 256, 7); *nbits = 7; }
  else { *code = bitrev(0xC0 + (sym - 280), 8); *nbits = 8; }
}

// ---------------------------------------------------------------------------
// Length-limited Huffman (package-merge, optimal for a given depth limit)
// ---------------------------------------------------------------------------
namespace {

struct PMItem {
  uint64_t w;
  int32_t sym;   // >=0 for a leaf
  int32_t a, b;  // arena indices of children (-1 = none)
};

// Count +1 code length for every leaf under arena[idx].
void pm_count(const PMItem* arena, int idx, uint8_t* cl) {
  int stack[64];
  int sp = 0;
  stack[sp++] = idx;
  while (sp) {
    int i = stack[--sp];
    const PMItem& it = arena[i];
    if (it.sym >= 0) cl[it.sym]++;
    if (it.a >= 0) stack[sp++] = it.a;
    if (it.b >= 0) stack[sp++] = it.b;
  }
}

// Compute optimal code lengths <= maxlen for freq[0..nsym). Requires
// nsym <= 300 and popcount(used) <= 2^maxlen.
void huff_lengths(const uint32_t* freq, int nsym, int maxlen,
                  uint8_t* len_out) {
  static thread_local PMItem arena[32 * 1024];
  int an = 0;
  int leaves[300];
  int m = 0;
  for (int s = 0; s < nsym; ++s) {
    len_out[s] = 0;
    if (freq[s]) leaves[m++] = s;
  }
  if (m == 0) return;
  if (m == 1) { len_out[leaves[0]] = 1; return; }
  // insertion-sort leaves by (freq, sym) — nsym tiny
  for (int i = 1; i < m; ++i) {
    int key = leaves[i];
    int j = i - 1;
    while (j >= 0 && (freq[leaves[j]] > freq[key] ||
                      (freq[leaves[j]] == freq[key] && leaves[j] > key))) {
      leaves[j + 1] = leaves[j];
      --j;
    }
    leaves[j + 1] = key;
  }
  int leaf_idx[300];
  for (int i = 0; i < m; ++i) {
    arena[an] = {freq[leaves[i]], leaves[i], -1, -1};
    leaf_idx[i] = an++;
  }
  static thread_local int list[1024], pkg[1024], merged[1024];
  int ln = m;
  for (int i = 0; i < m; ++i) list[i] = leaf_idx[i];
  for (int it = 1; it < maxlen; ++it) {
    int pn = ln / 2;
    for (int j = 0; j < pn; ++j) {
      arena[an] = {arena[list[2 * j]].w + arena[list[2 * j + 1]].w, -1,
                   list[2 * j], list[2 * j + 1]};
      pkg[j] = an++;
    }
    // merge leaves and packages by weight
    int i1 = 0, i2 = 0, k = 0;
    while (i1 < m || i2 < pn) {
      if (i2 >= pn ||
          (i1 < m && arena[leaf_idx[i1]].w <= arena[pkg[i2]].w)) {
        merged[k++] = leaf_idx[i1++];
      } else {
        merged[k++] = pkg[i2++];
      }
    }
    ln = k;
    for (int j = 0; j < ln; ++j) list[j] = merged[j];
  }
  int take = 2 * m - 2;
  for (int j = 0; j < take && j < ln; ++j) pm_count(arena, list[j], len_out);
}

// Canonical code assignment (RFC1951 §3.2.2), bit-reversed for LSB-first.
void canonical_codes(const uint8_t* lens, int nsym, uint16_t* codes) {
  int bl_count[16] = {0};
  for (int s = 0; s < nsym; ++s) bl_count[lens[s]]++;
  bl_count[0] = 0;
  uint32_t next_code[16] = {0};
  uint32_t code = 0;
  for (int b = 1; b <= 15; ++b) {
    code = (code + bl_count[b - 1]) << 1;
    next_code[b] = code;
  }
  for (int s = 0; s < nsym; ++s) {
    if (lens[s]) codes[s] = (uint16_t)bitrev(next_code[lens[s]]++, lens[s]);
    else codes[s] = 0;
  }
}

// RLE a code-length sequence into (sym, extra, extrabits) ops per §3.2.7.
struct CLOp { uint8_t sym, extra_bits; uint8_t extra; };

int rle_code_lengths(const uint8_t* lens, int n, CLOp* ops) {
  int no = 0;
  int i = 0;
  while (i < n) {
    uint8_t v = lens[i];
    int run = 1;
    while (i + run < n && lens[i + run] == v) ++run;
    if (v == 0) {
      while (run >= 3) {
        if (run >= 11) {
          int r = run > 138 ? 138 : run;
          ops[no++] = {18, 7, (uint8_t)(r - 11)};
          run -= r;
          i += r;
        } else {
          ops[no++] = {17, 3, (uint8_t)(run - 3)};
          i += run;
          run = 0;
        }
      }
      while (run--) { ops[no++] = {0, 0, 0}; ++i; }
    } else {
      ops[no++] = {v, 0, 0};
      ++i;
      --run;
      while (run >= 3) {
        int r = run > 6 ? 6 : run;
        ops[no++] = {16, 2, (uint8_t)(r - 3)};
        run -= r;
        i += r;
      }
      while (run--) { ops[no++] = {v, 0, 0}; ++i; }
    }
  }
  return no;
}

const uint8_t CL_ORDER[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                              11, 4, 12, 3, 13, 2, 14, 1, 15};

// token unpack helpers (packed u32 tokens from the device pipeline):
//   match:        bit31=1, [16,31) match length, [0,16) dist-1
//   literal run:  bit31=0 bit30=1, [0,14) run length (bytes read from src
//                 at the running position)
//   literal byte: bit31=0 bit30=0, [0,8) byte
static inline bool tok_is_match(uint32_t t) { return (t >> 31) != 0; }
static inline bool tok_is_litrun(uint32_t t) { return (t >> 30) == 1; }
static inline int tok_len(uint32_t t) { return (int)((t >> 16) & 0x7FFF); }
static inline int tok_dist(uint32_t t) { return (int)(t & 0xFFFF) + 1; }
static inline int tok_lit(uint32_t t) { return (int)(t & 0xFF); }
static inline int tok_runlen(uint32_t t) { return (int)(t & 0x3FFF); }

}  // namespace

// Emit stored (BTYPE=00) blocks covering src. Used for incompressible
// chunks — the reference's CnV-failure fallback emits stored blocks the
// same way (qzDeflateStoredBlocks, src/qatzip.c:1591).
static int64_t emit_stored(BitWriter& bw, const uint8_t* src, int64_t n,
                           int32_t final_block) {
  int64_t off = 0;
  do {
    int64_t blk = n - off > 65535 ? 65535 : n - off;
    bool last = (off + blk == n);
    bw.put((final_block && last) ? 1u : 0u, 1);
    bw.put(0u, 2);
    bw.flush();
    if (bw.overflow) return -1;
    // align to byte
    bw.bitpos = (bw.bitpos + 7) & ~7ll;
    int64_t byte = bw.bitpos >> 3;
    if (byte + 4 + blk > bw.cap) { bw.overflow = true; return -1; }
    bw.dst[byte] = (uint8_t)(blk & 0xFF);
    bw.dst[byte + 1] = (uint8_t)(blk >> 8);
    bw.dst[byte + 2] = (uint8_t)(~blk & 0xFF);
    bw.dst[byte + 3] = (uint8_t)((~blk >> 8) & 0xFF);
    std::memcpy(bw.dst + byte + 4, src + off, (size_t)blk);
    bw.bitpos += (4 + blk) * 8;
    off += blk;
  } while (off < n);
  return 0;
}

// Pack one chunk's tokens into a raw DEFLATE stream, choosing the smallest
// of stored / static / dynamic encodings (mode 0), or forcing static (1) /
// dynamic (2) — the session's QzHuffmanHdr_T knob (include/qatzip.h:179).
// final!=0 sets BFINAL; final==0 appends an empty stored block for byte
// alignment (Z_FULL_FLUSH semantics, matching the reference's per-chunk
// FLUSH_FULL policy, src/qatzip.c:1384-1394).
// Returns bytes written, or -1 on overflow.
int64_t qz_deflate_pack(const uint8_t* src, int64_t n, const uint32_t* toks,
                        int64_t ntok, uint8_t* dst, int64_t cap,
                        int32_t final_block, int32_t mode) {
  if (!luts_init) init_luts();
  // no dst pre-zeroing: the BitWriter's flush is self-sufficient (see
  // struct note). Speed-neutral (A/B 274-291 both ways — the 64 KB
  // memset was cheap on warm pages) but removes the latent requirement
  // that pooled/recycled dst buffers arrive zeroed.

  // ----- histograms ------------------------------------------------------
  // literal counts use 4 interleaved tables: a run of equal bytes (DNA,
  // RLE text) otherwise serializes on one counter's load-add-store chain
  uint32_t lfreq[288] = {0}, dfreq[30] = {0};
  static thread_local uint32_t lf4[3][256];
  std::memset(lf4, 0, sizeof(lf4));
  uint64_t extra_bits = 0;
  {
    int64_t pos = 0;
    for (int64_t i = 0; i < ntok; ++i) {
      uint32_t t = toks[i];
      if (tok_is_match(t)) {
        int len = tok_len(t);
        int d = tok_dist(t);
        // trust boundary: tokens cross a C ABI — reject out-of-alphabet
        // lengths/distances instead of indexing LUTs out of bounds
        if (len < 3 || len > 258 || d < 1 || d > 32768 || pos + len > n)
          return -2;
        int lc = len_code_lut[len];
        lfreq[257 + lc]++;
        extra_bits += LEN_EXTRA[lc];
        int dc = dist_code(d);
        dfreq[dc]++;
        extra_bits += DIST_EXTRA[dc];
        pos += len;
      } else if (tok_is_litrun(t)) {
        int run = tok_runlen(t);
        if (pos + run > n) return -2;
        const uint8_t* p = src + pos;
        int k = 0;
        for (; k + 4 <= run; k += 4) {
          lfreq[p[k]]++;
          lf4[0][p[k + 1]]++;
          lf4[1][p[k + 2]]++;
          lf4[2][p[k + 3]]++;
        }
        for (; k < run; ++k) lfreq[p[k]]++;
        pos += run;
      } else {
        lfreq[tok_lit(t)]++;
        ++pos;
      }
    }
  }
  for (int s = 0; s < 256; ++s)
    lfreq[s] += lf4[0][s] + lf4[1][s] + lf4[2][s];
  lfreq[256]++;  // EOB

  // ----- static cost -----------------------------------------------------
  uint64_t static_bits = 3 + extra_bits;
  for (int s = 0; s < 288; ++s) {
    if (!lfreq[s]) continue;
    int nb = s <= 143 ? 8 : s <= 255 ? 9 : s <= 279 ? 7 : 8;
    static_bits += (uint64_t)lfreq[s] * nb;
  }
  for (int d = 0; d < 30; ++d) static_bits += (uint64_t)dfreq[d] * 5;

  // ----- dynamic cost ----------------------------------------------------
  uint8_t llen[288], dlen[30];
  uint16_t lcode[288], dcode[30];
  huff_lengths(lfreq, 288, 15, llen);
  huff_lengths(dfreq, 30, 15, dlen);
  int hlit = 257, hdist = 1;
  for (int s = 257; s < 288; ++s) if (llen[s]) hlit = s + 1;
  for (int d = 0; d < 30; ++d) if (dlen[d]) hdist = d + 1;
  uint8_t all_lens[318];
  std::memcpy(all_lens, llen, (size_t)hlit);
  std::memcpy(all_lens + hlit, dlen, (size_t)hdist);
  static thread_local CLOp ops[318];
  int nops = rle_code_lengths(all_lens, hlit + hdist, ops);
  uint32_t clfreq[19] = {0};
  for (int i = 0; i < nops; ++i) clfreq[ops[i].sym]++;
  uint8_t cllen[19];
  uint16_t clcode[19];
  huff_lengths(clfreq, 19, 7, cllen);
  int hclen = 4;
  for (int i = 0; i < 19; ++i) if (cllen[CL_ORDER[i]]) hclen = i + 1;
  uint64_t dyn_bits = 3 + 5 + 5 + 4 + (uint64_t)hclen * 3 + extra_bits;
  for (int i = 0; i < nops; ++i)
    dyn_bits += cllen[ops[i].sym] + ops[i].extra_bits;
  for (int s = 0; s < 288; ++s) dyn_bits += (uint64_t)lfreq[s] * llen[s];
  for (int d = 0; d < 30; ++d) dyn_bits += (uint64_t)dfreq[d] * dlen[d];

  uint64_t stored_bits = n ? ((uint64_t)n + 5 * ((n + 65534) / 65535)) * 8 + 7
                           : ~0ull;  // empty input: never stored

  // ----- choose ----------------------------------------------------------
  int choice;  // 0 stored, 1 static, 2 dynamic
  if (mode == 1) choice = static_bits <= stored_bits ? 1 : 0;
  else if (mode == 2) choice = dyn_bits <= stored_bits ? 2 : 0;
  else choice = (stored_bits <= static_bits && stored_bits <= dyn_bits) ? 0
              : (dyn_bits < static_bits ? 2 : 1);

  BitWriter bw{dst, cap, 0, false};
  if (choice == 0) {
    if (emit_stored(bw, src, n, final_block) < 0) return -1;
  } else if (choice == 1) {
    bw.put(final_block ? 1u : 0u, 1);
    bw.put(1u, 2);
    int64_t pos = 0;
    for (int64_t i = 0; i < ntok && !bw.overflow; ++i) {
      uint32_t t = toks[i];
      uint32_t code; int nb;
      if (tok_is_match(t)) {
        int len = tok_len(t);
        int lc = len_code_lut[len];
        static_lit_code(257 + lc, &code, &nb);
        bw.put(code, nb);
        if (LEN_EXTRA[lc]) bw.put((uint32_t)(len - LEN_BASE[lc]), LEN_EXTRA[lc]);
        int d = tok_dist(t);
        int dc = dist_code(d);
        bw.put(bitrev((uint32_t)dc, 5), 5);
        if (DIST_EXTRA[dc]) bw.put((uint32_t)(d - DIST_BASE[dc]), DIST_EXTRA[dc]);
        pos += len;
      } else if (tok_is_litrun(t)) {
        int run = tok_runlen(t);
        for (int k = 0; k < run && !bw.overflow; ++k) {
          static_lit_code(src[pos + k], &code, &nb);
          bw.put(code, nb);
        }
        pos += run;
      } else {
        static_lit_code(tok_lit(t), &code, &nb);
        bw.put(code, nb);
        ++pos;
      }
    }
    uint32_t code; int nb;
    static_lit_code(256, &code, &nb);
    bw.put(code, nb);
  } else {
    canonical_codes(llen, 288, lcode);
    canonical_codes(dlen, 30, dcode);
    canonical_codes(cllen, 19, clcode);
    bw.put(final_block ? 1u : 0u, 1);
    bw.put(2u, 2);
    bw.put((uint32_t)(hlit - 257), 5);
    bw.put((uint32_t)(hdist - 1), 5);
    bw.put((uint32_t)(hclen - 4), 4);
    for (int i = 0; i < hclen; ++i) bw.put(cllen[CL_ORDER[i]], 3);
    for (int i = 0; i < nops; ++i) {
      bw.put(clcode[ops[i].sym], cllen[ops[i].sym]);
      if (ops[i].extra_bits) bw.put(ops[i].extra, ops[i].extra_bits);
    }
    int64_t pos = 0;
    for (int64_t i = 0; i < ntok && !bw.overflow; ++i) {
      uint32_t t = toks[i];
      if (tok_is_match(t)) {
        int len = tok_len(t);
        int lc = len_code_lut[len];
        bw.put(lcode[257 + lc], llen[257 + lc]);
        if (LEN_EXTRA[lc]) bw.put((uint32_t)(len - LEN_BASE[lc]), LEN_EXTRA[lc]);
        int d = tok_dist(t);
        int dc = dist_code(d);
        bw.put(dcode[dc], dlen[dc]);
        if (DIST_EXTRA[dc]) bw.put((uint32_t)(d - DIST_BASE[dc]), DIST_EXTRA[dc]);
        pos += len;
      } else if (tok_is_litrun(t)) {
        int run = tok_runlen(t);
        for (int k = 0; k < run && !bw.overflow; ++k) {
          int lit = src[pos + k];
          bw.put(lcode[lit], llen[lit]);
        }
        pos += run;
      } else {
        int lit = tok_lit(t);
        bw.put(lcode[lit], llen[lit]);
        ++pos;
      }
    }
    bw.put(lcode[256], llen[256]);
  }

  if (!final_block) {
    // byte-align with an empty stored block (sync flush)
    bw.put(0u, 1);
    bw.put(0u, 2);
    bw.flush();
    bw.bitpos = (bw.bitpos + 7) & ~7ll;
    int64_t byte = bw.bitpos >> 3;
    if (byte + 4 > cap) return -1;
    dst[byte] = 0; dst[byte + 1] = 0; dst[byte + 2] = 0xFF; dst[byte + 3] = 0xFF;
    bw.bitpos += 32;
  }
  bw.flush();
  if (bw.overflow) return -1;
  return (bw.bitpos + 7) >> 3;
}

// Pack device tokens into a standard LZ4 block, enforcing the LZ4 end rules
// (last 5 bytes literal; no match starting within the last 12 bytes) by
// demoting/trimming offending matches to literals. Returns bytes written,
// 0 when dst is too small.
// Build a per-chunk dynamic-Huffman plan from a device histogram
// (the host leg of the two-pass on-device dynamic pack,
// ops/deflate_pack.py): lfreq[286] are lit/len counts (caller adds the
// EOB), dfreq[30] are distance-symbol counts. BOTH trees are optimal
// length-limited-`limit` (typically 12 — the device splits each match
// into a length part at p and a distance part at p+1, so every emission
// fits one 32-bit word). Fills lit_pack[286]/dist_pack[30] = bit-reversed
// code | len<<12 and writes the complete block-header bitstream
// (BFINAL=0, BTYPE=10, HLIT/HDIST/HCLEN, code-length code, RLE'd
// lengths) into hdr_dst. Returns the header bit length, or -1 on error.
int64_t qz_dyn_plan(const uint32_t* lfreq, const uint32_t* dfreq,
                    int32_t limit, uint16_t* lit_pack, uint16_t* dist_pack,
                    uint8_t* hdr_dst, int64_t hdr_cap) {
  if (limit < 1 || limit > 12) return -1;
  // a length-limited code is only feasible when used symbols <= 2^limit
  // (huff_lengths would silently build an over-subscribed tree otherwise)
  int used = 0;
  for (int s = 0; s < 286; ++s) used += lfreq[s] != 0;
  if (used > (1 << limit)) return -1;
  int dused = 0;
  for (int d = 0; d < 30; ++d) dused += dfreq[d] != 0;
  if (dused > (1 << limit)) return -1;
  uint8_t llen[286];
  uint16_t lcode[286];
  huff_lengths(lfreq, 286, limit, llen);
  canonical_codes(llen, 286, lcode);
  for (int s = 0; s < 286; ++s)
    lit_pack[s] = (uint16_t)(lcode[s] | ((uint16_t)llen[s] << 12));
  uint8_t dlen[30];
  uint16_t dcode[30];
  huff_lengths(dfreq, 30, limit, dlen);
  // a dynamic block needs >=1 distance code even if no matches occur
  bool any_d = false;
  for (int d = 0; d < 30; ++d) any_d |= dlen[d] != 0;
  if (!any_d) dlen[0] = 1;
  canonical_codes(dlen, 30, dcode);
  for (int d = 0; d < 30; ++d)
    dist_pack[d] = (uint16_t)(dcode[d] | ((uint16_t)dlen[d] << 12));
  int hdist = 30;
  while (hdist > 1 && dlen[hdist - 1] == 0) --hdist;
  uint8_t all[316];
  std::memcpy(all, llen, 286);
  std::memcpy(all + 286, dlen, (size_t)hdist);
  CLOp ops[330];
  int nops = rle_code_lengths(all, 286 + hdist, ops);
  uint32_t clfreq[19] = {0};
  for (int i = 0; i < nops; ++i) clfreq[ops[i].sym]++;
  uint8_t cllen[19];
  uint16_t clcode[19];
  huff_lengths(clfreq, 19, 7, cllen);
  canonical_codes(cllen, 19, clcode);
  int hclen = 19;
  while (hclen > 4 && cllen[CL_ORDER[hclen - 1]] == 0) --hclen;
  std::memset(hdr_dst, 0, (size_t)hdr_cap);
  BitWriter bw{hdr_dst, hdr_cap, 0, false};
  bw.put(0u, 1);            // BFINAL=0 (host flips for final chunks)
  bw.put(2u, 2);            // BTYPE=10 dynamic
  bw.put(286 - 257, 5);
  bw.put((uint32_t)(hdist - 1), 5);
  bw.put((uint32_t)(hclen - 4), 4);
  for (int i = 0; i < hclen; ++i) bw.put(cllen[CL_ORDER[i]], 3);
  for (int i = 0; i < nops; ++i) {
    bw.put(clcode[ops[i].sym], cllen[ops[i].sym]);
    if (ops[i].extra_bits) bw.put(ops[i].extra, ops[i].extra_bits);
  }
  bw.flush();
  if (bw.overflow) return -1;
  return bw.bitpos;
}

int64_t qz_lz4_pack(const uint8_t* src, int64_t n, const uint32_t* toks,
                    int64_t ntok, uint8_t* dst, int64_t cap) {
  uint8_t* op = dst;
  uint8_t* oend = dst + cap;
  if (n == 0) {
    if (cap < 1) return 0;
    *op = 0;
    return 1;
  }
  int64_t pos = 0, anchor = 0;
  for (int64_t i = 0; i < ntok; ++i) {
    uint32_t t = toks[i];
    if (!tok_is_match(t)) {
      pos += tok_is_litrun(t) ? tok_runlen(t) : 1;
      if (pos > n) return -1;  // overstated run past input
      continue;
    }
    int ml = tok_len(t);
    int dist = tok_dist(t);
    // trust boundary: the 2-byte LZ4 offset field cannot express dist >
    // 65535 — reject instead of truncating to an invalid offset-0 stream
    // (mirrors qz_deflate_pack's distance check at the C ABI)
    if (ml < LZ4_MINMATCH || dist < 1 || dist > 65535 || pos + ml > n)
      return -1;
    int64_t advance = ml;
    if (pos > n - 12) { pos += advance; continue; }          // demote
    int64_t maxend = n - 5;
    int eml = ml;
    if (pos + eml > maxend) eml = (int)(maxend - pos);
    if (eml < LZ4_MINMATCH) { pos += advance; continue; }    // demote
    op = lz4_emit(op, oend, src + anchor, (size_t)(pos - anchor),
                  (size_t)(eml - LZ4_MINMATCH), (uint16_t)dist, true);
    if (!op) return 0;
    pos += advance;
    anchor = pos - (advance - eml);  // trimmed tail becomes literals
  }
  // trailing literals
  op = lz4_emit(op, oend, src + anchor, (size_t)(n - anchor), 0, 0, false);
  if (!op) return 0;
  return (int64_t)(op - dst);
}

// Pack device tokens into an LZ4s block (stored match length is
// len-(mini_match-1); trailing literal-only sequence has no offset field).
int64_t qz_lz4s_pack(const uint8_t* src, int64_t n, const uint32_t* toks,
                     int64_t ntok, uint8_t* dst, int64_t cap,
                     int32_t mini_match) {
  if (mini_match != 3 && mini_match != 4) return -1;
  const uint32_t base = (uint32_t)(mini_match - 1);
  uint8_t* op = dst;
  uint8_t* oend = dst + cap;
  if (n == 0) {
    if (cap < 1) return 0;
    *op = 0;
    return 1;
  }
  int64_t pos = 0, anchor = 0;
  for (int64_t i = 0; i < ntok; ++i) {
    uint32_t t = toks[i];
    if (!tok_is_match(t)) {
      pos += tok_is_litrun(t) ? tok_runlen(t) : 1;
      if (pos > n) return -1;  // overstated run past input
      continue;
    }
    int ml = tok_len(t);
    int dist = tok_dist(t);
    if (ml < (int)base + 1 || dist < 1 || dist > 65535 || pos + ml > n)
      return -1;
    size_t lit = (size_t)(pos - anchor);
    size_t stored = (size_t)ml - base;
    size_t need = 1 + lit / 255 + 1 + lit + 2 + 1 + stored / 255;
    if (op + need + 8 > oend) return 0;
    uint8_t* tk = op++;
    if (lit >= 15) {
      *tk = (uint8_t)(15 << 4);
      size_t r = lit - 15;
      while (r >= 255) { *op++ = 255; r -= 255; }
      *op++ = (uint8_t)r;
    } else {
      *tk = (uint8_t)(lit << 4);
    }
    std::memcpy(op, src + anchor, lit);
    op += lit;
    op[0] = (uint8_t)(dist & 0xFF);
    op[1] = (uint8_t)(dist >> 8);
    op += 2;
    if (stored >= 15) {
      *tk |= 15;
      size_t r = stored - 15;
      while (r >= 255) { *op++ = 255; r -= 255; }
      *op++ = (uint8_t)r;
    } else {
      *tk |= (uint8_t)stored;
    }
    pos += ml;
    anchor = pos;
  }
  op = lz4_emit(op, oend, src + anchor, (size_t)(n - anchor), 0, 0, false);
  if (!op) return 0;
  return (int64_t)(op - dst);
}

int64_t qz_deflate_static_block(const uint8_t* lits, const uint16_t* lens,
                                const uint16_t* dists, int64_t ntok,
                                uint8_t* dst, int64_t cap, int64_t bitpos,
                                int32_t final_block, int64_t* out_bitpos) {
  if (!luts_init) init_luts();
  BitWriter bw{dst, cap, bitpos, false};
  bw.put(final_block ? 1u : 0u, 1);
  bw.put(1u, 2);  // BTYPE=01 static
  for (int64_t i = 0; i < ntok; ++i) {
    if (lens[i] == 0) {
      uint32_t code; int nb;
      static_lit_code(lits[i], &code, &nb);
      bw.put(code, nb);
    } else {
      int len = lens[i];
      int lc = len_code_lut[len];
      uint32_t code; int nb;
      static_lit_code(257 + lc, &code, &nb);
      bw.put(code, nb);
      if (LEN_EXTRA[lc]) bw.put((uint32_t)(len - LEN_BASE[lc]), LEN_EXTRA[lc]);
      int d = dists[i];
      int dc = dist_code(d);
      bw.put(bitrev((uint32_t)dc, 5), 5);
      if (DIST_EXTRA[dc]) bw.put((uint32_t)(d - DIST_BASE[dc]), DIST_EXTRA[dc]);
    }
  }
  // end-of-block (symbol 256)
  {
    uint32_t code; int nb;
    static_lit_code(256, &code, &nb);
    bw.put(code, nb);
  }
  bw.flush();
  if (bw.overflow) return -1;
  *out_bitpos = bw.bitpos;
  return (bw.bitpos + 7) >> 3;
}

// Parse an LZ4 block into a reference plane for device-side resolution:
// ref[i] = -(byte+1) for literal output positions (resolved values), or
// the source output index (i - offset) for match positions. The device
// then resolves match chains by pointer doubling (ops/lz4_decode.py) —
// the serial window-copy dependency expressed as log-depth gathers.
// Returns decoded length or -1 on malformed input.
int64_t qz_lz4_ref_block(const uint8_t* src, int64_t n, int32_t* ref,
                         int64_t cap) {
  const uint8_t* ip = src;
  const uint8_t* iend = src + n;
  int64_t pos = 0;
  if (n == 0) return -1;
  while (ip < iend) {
    uint32_t token = *ip++;
    int64_t litlen = token >> 4;
    if (litlen == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        litlen += b;
      } while (b == 255);
    }
    if (ip + litlen > iend || pos + litlen > cap) return -1;
    for (int64_t k = 0; k < litlen; ++k) ref[pos + k] = -1 - (int32_t)ip[k];
    ip += litlen;
    pos += litlen;
    if (ip >= iend) break;  // last sequence: literals only
    if (ip + 2 > iend) return -1;
    uint32_t off = ip[0] | (ip[1] << 8);
    ip += 2;
    if (off == 0 || off > pos) return -1;
    int64_t mlen = (token & 15);
    if (mlen == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        mlen += b;
      } while (b == 255);
    }
    mlen += 4;
    if (pos + mlen > cap) return -1;
    for (int64_t k = 0; k < mlen; ++k)
      ref[pos + k] = (int32_t)(pos + k - off);
    pos += mlen;
  }
  return pos;
}

// ---------------------------------------------------------------------------
// Fast raw-DEFLATE inflate — the decompress hot loop's host leg.
//
// The reference offloads the whole decompress loop to QAT silicon
// (src/qatzip.c:2374-2797, cpaDcDecompressData at :2543); our members are
// decoded host-side in parallel worker threads, so the per-core decode rate
// is the ceiling. zlib's inflate measures ~356 MB/s/core here; this
// implementation (64-bit bit buffer, flat 15-bit first-level Huffman
// tables, 8-byte pattern copies) targets ~2x that. Written from RFC1951.
// ---------------------------------------------------------------------------

namespace {

struct BitIn {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t bits;
  int nbits;
  int pad;  // phantom zero bytes fed past the end

  void init(const uint8_t* src, int64_t n) {
    p = src;
    end = src + n;
    bits = 0;
    nbits = 0;
    pad = 0;
  }
  // true when any phantom (past-end) bit has been consumed — phantom
  // bytes are the newest, so they are intact iff nbits still covers them
  inline bool overran() const { return pad * 8 > nbits; }
  inline void refill() {
    if (end - p >= 8) {
      uint64_t w;
      std::memcpy(&w, p, 8);
      bits |= w << nbits;
      p += (63 - nbits) >> 3;
      nbits |= 56;
      return;
    }
    while (nbits <= 56) {
      if (p < end) {
        bits |= (uint64_t)(*p++) << nbits;
        nbits += 8;
      } else if (pad >= 4) {
        break;
      } else {
        // past the end: feed zeros; consuming them = truncated stream
        ++pad;
        nbits += 8;
      }
    }
  }
  inline uint32_t peek(int k) { return (uint32_t)(bits & ((1u << k) - 1)); }
  inline void drop(int k) {
    bits >>= k;
    nbits -= k;
  }
  inline uint32_t get(int k) {
    uint32_t v = (uint32_t)(bits & ((1ull << k) - 1));
    drop(k);
    return v;
  }
};

// Two-level Huffman decode table (zlib-style): 10-bit root, per-prefix
// subtables for codes longer than ROOT. Root entry layout:
//   direct:   (sym << 5) | len            (len <= ROOT, len in bits 0-4)
//   subtable: 0x80000000 | (suboff << 5) | sublen
// Sub entry layout: (sym << 5) | full_len.  0 = invalid.
static const int HUFF_ROOT = 10;

struct HuffTable {
  uint32_t root[1 << HUFF_ROOT];
  uint32_t sub[1 << 13];
  uint32_t sub_used;   // sub entries actually allocated by build_table
};

// build from canonical code lengths; returns false on oversubscription
static bool build_table(const uint8_t* lens, int nsyms, HuffTable* ht) {
  int count[16] = {0};
  for (int i = 0; i < nsyms; ++i) {
    if (lens[i] > 15) return false;
    count[lens[i]]++;
  }
  count[0] = 0;
  uint32_t code = 0;
  uint32_t next[16] = {0};
  for (int l = 1; l <= 15; ++l) {
    code = (code + count[l - 1]) << 1;
    next[l] = code;
  }
  uint32_t left = 1 << 15;
  for (int l = 1; l <= 15; ++l) {
    if ((uint32_t)count[l] << (15 - l) > left) return false;
    left -= (uint32_t)count[l] << (15 - l);
  }
  std::memset(ht->root, 0, sizeof(ht->root));
  // pass 1: per-root-prefix max length of long codes -> subtable sizes
  uint8_t submax[1 << HUFF_ROOT];
  std::memset(submax, 0, sizeof(submax));
  uint32_t nxt2[16];
  std::memcpy(nxt2, next, sizeof(nxt2));
  bool any_long = false;
  for (int i = 0; i < nsyms; ++i) {
    int l = lens[i];
    if (l <= HUFF_ROOT) {
      if (l) nxt2[l]++;
      continue;
    }
    any_long = true;
    uint32_t c = nxt2[l]++;
    uint32_t r = 0;
    for (int k = 0; k < l; ++k) r |= ((c >> k) & 1) << (l - 1 - k);
    uint32_t prefix = r & ((1u << HUFF_ROOT) - 1);
    uint8_t need = (uint8_t)(l - HUFF_ROOT);
    if (need > submax[prefix]) submax[prefix] = need;
  }
  uint32_t suboff_acc = 0;
  uint32_t suboff[1 << HUFF_ROOT];
  if (any_long) {
    for (int pr = 0; pr < (1 << HUFF_ROOT); ++pr) {
      suboff[pr] = suboff_acc;
      if (submax[pr]) {
        uint32_t sz = 1u << submax[pr];
        if (suboff_acc + sz > (1u << 13)) return false;
        std::memset(ht->sub + suboff_acc, 0, sz * sizeof(uint32_t));
        ht->root[pr] = 0x80000000u | (suboff_acc << 5) | submax[pr];
        suboff_acc += sz;
      }
    }
  }
  ht->sub_used = suboff_acc;
  // pass 2: fill entries
  for (int i = 0; i < nsyms; ++i) {
    int l = lens[i];
    if (!l) continue;
    uint32_t c = next[l]++;
    uint32_t r = 0;
    for (int k = 0; k < l; ++k) r |= ((c >> k) & 1) << (l - 1 - k);
    if (l <= HUFF_ROOT) {
      uint32_t entry = ((uint32_t)i << 5) | (uint32_t)l;
      for (uint32_t fill = r; fill < (1u << HUFF_ROOT); fill += 1u << l)
        ht->root[fill] = entry;
    } else {
      uint32_t prefix = r & ((1u << HUFF_ROOT) - 1);
      uint32_t rest = r >> HUFF_ROOT;          // (l - ROOT) bits
      uint32_t sm = submax[prefix];
      uint32_t base = suboff[prefix];
      uint32_t entry = ((uint32_t)i << 5) | (uint32_t)l;
      for (uint32_t fill = rest; fill < (1u << sm);
           fill += 1u << (l - HUFF_ROOT))
        ht->sub[base + fill] = entry;
    }
  }
  return true;
}

static const uint16_t LEN_BASE_TBL[29] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
    31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
static const uint8_t LEN_EXTRA_TBL[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                                          1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                                          4, 4, 4, 4, 5, 5, 5, 5, 0};
static const uint16_t DIST_BASE_TBL[30] = {
    1,    2,    3,    4,    5,    7,    9,    13,   17,   25,
    33,   49,   65,   97,   129,  193,  257,  385,  513,  769,
    1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577};
static const uint8_t DIST_EXTRA_TBL[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,
                                           4, 4, 5, 5, 6, 6, 7, 7,  8,  8,
                                           9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

// ---------------------------------------------------------------------------
// Packed-entry transform for the MAIN decode tables (litlen + dist).
// build_table emits generic (sym << 5 | len) entries; the hot loop wants
// everything a symbol implies in ONE load (libdeflate's trick), so the
// tables are re-written in place:
//   litlen:  literal   0x20000000 | byte<<8           | len
//            EOB       0x40000000                     | len
//            match     len_base<<16 | len_extra<<5    | len
//            sym>285   0 (malformed — same path as "no code")
//   dist:    dist_base<<16 | dist_extra<<5 | len      (sym>29 -> 0)
// Root subtable pointers (bit31) pass through unchanged; dist_base<<16
// can set bits 29/30 but the dist table carries no flags, so that's fine.
// ---------------------------------------------------------------------------
static void pack_entries(HuffTable* ht, bool is_litlen) {
  auto xf = [is_litlen](uint32_t e) -> uint32_t {
    if (!e || (e & 0x80000000u)) return e;
    uint32_t sym = e >> 5, len = e & 31;
    if (is_litlen) {
      if (sym < 256) return 0x20000000u | (sym << 8) | len;
      if (sym == 256) return 0x40000000u | len;
      if (sym > 285) return 0;
      uint32_t li = sym - 257;
      return ((uint32_t)LEN_BASE_TBL[li] << 16) |
             ((uint32_t)LEN_EXTRA_TBL[li] << 5) | len;
    }
    if (sym > 29) return 0;
    return ((uint32_t)DIST_BASE_TBL[sym] << 16) |
           ((uint32_t)DIST_EXTRA_TBL[sym] << 5) | len;
  };
  if (is_litlen) {
    // literal-PAIR root entries (libdeflate's trick): when the literal
    // at root index i has code length l1 and the following bits decode
    // to another literal whose length fits the remaining ROOT-l1 bits,
    // one load yields BOTH bytes. Validity: the zero-padded index
    // i >> l1 resolves identically to the real continuation iff
    // l2 <= ROOT - l1 (table fill covers all high-bit continuations),
    // and prefix-freeness makes a false pair impossible at decode time.
    // Dominant for short-code alphabets (DNA: 2-3 bit literals).
    //   pair: 0x30000000 | byte2<<16 | byte1<<8 | (l1+l2)
    uint32_t orig[1 << HUFF_ROOT];
    std::memcpy(orig, ht->root, sizeof(orig));
    for (uint32_t i = 0; i < (1u << HUFF_ROOT); ++i) {
      uint32_t e1 = orig[i];
      if (e1 && !(e1 & 0x80000000u)) {
        uint32_t sym1 = e1 >> 5, l1 = e1 & 31;
        if (sym1 < 256) {
          uint32_t e2 = orig[i >> l1];
          if (e2 && !(e2 & 0x80000000u)) {
            uint32_t sym2 = e2 >> 5, l2 = e2 & 31;
            if (sym2 < 256 && l1 + l2 <= (uint32_t)HUFF_ROOT) {
              ht->root[i] =
                  0x30000000u | (sym2 << 16) | (sym1 << 8) | (l1 + l2);
              continue;
            }
          }
        }
      }
      ht->root[i] = xf(e1);
    }
  } else {
    for (uint32_t i = 0; i < (1u << HUFF_ROOT); ++i)
      ht->root[i] = xf(ht->root[i]);
  }
  for (uint32_t i = 0; i < ht->sub_used; ++i) ht->sub[i] = xf(ht->sub[i]);
}

// one load resolving root + optional subtable indirection
static inline uint32_t resolve_packed(const HuffTable& ht, uint64_t bits) {
  uint32_t e = ht.root[(uint32_t)bits & ((1u << HUFF_ROOT) - 1)];
  if (e & 0x80000000u)
    e = ht.sub[((e >> 5) & 0x3FFFFFFu) +
               (((uint32_t)(bits >> HUFF_ROOT)) & ((1u << (e & 31)) - 1))];
  return e;
}

static HuffTable g_static_lit;
static HuffTable g_static_dist;

static void init_static_tables() {
  uint8_t ll[288];
  for (int i = 0; i < 144; ++i) ll[i] = 8;
  for (int i = 144; i < 256; ++i) ll[i] = 9;
  for (int i = 256; i < 280; ++i) ll[i] = 7;
  for (int i = 280; i < 288; ++i) ll[i] = 8;
  build_table(ll, 288, &g_static_lit);
  pack_entries(&g_static_lit, true);
  uint8_t dl[30];
  for (int i = 0; i < 30; ++i) dl[i] = 5;
  build_table(dl, 30, &g_static_dist);
  pack_entries(&g_static_dist, false);
}

static inline int decode_sym_nr(BitIn& in, const HuffTable& ht) {
  uint32_t e = ht.root[(uint32_t)in.bits & ((1u << HUFF_ROOT) - 1)];
  if (e & 0x80000000u) {
    uint32_t sublen = e & 31;
    uint32_t suboff = (e >> 5) & 0x3FFFFFF;
    e = ht.sub[suboff +
               (((uint32_t)(in.bits >> HUFF_ROOT)) & ((1u << sublen) - 1))];
  }
  if (!e) return -1;
  int l = (int)(e & 31);
  if (l > in.nbits) return -1;
  in.drop(l);
  return (int)(e >> 5);
}

static inline int decode_sym(BitIn& in, const HuffTable& ht) {
  in.refill();
  return decode_sym_nr(in, ht);
}

// overlap-safe backward copy. Fast paths (16-byte stamps for dist >= 16,
// seed-then-double window growth for 2 <= dist < 16) need a 16-byte skid
// past len; the byte loop handles the buffer tail exactly.
static inline void copy_match(uint8_t* op, int64_t dist, int64_t len,
                              uint8_t* out_end_cap) {
  const uint8_t* src = op - dist;
  if (dist == 1) {           // RLE run — the most common overlap case
    std::memset(op, src[0], (size_t)len);
    return;
  }
  if (op + len + 16 <= out_end_cap) {
    if (dist >= 16 || dist >= len) {
      // 16-byte stamps. dist >= len means the logical copy never
      // overlaps even when dist < 16; staging through locals keeps each
      // memcpy's argument ranges disjoint (no overlapping-memcpy UB),
      // and stamps that read bytes an earlier stamp wrote (16 <= dist <
      // len) see completed writes — the periodic-copy semantics.
      uint8_t* o = op;
      const uint8_t* s = src;
      int64_t k = len;
      do {
        uint64_t a0, a1;
        std::memcpy(&a0, s, 8);
        std::memcpy(&a1, s + 8, 8);
        std::memcpy(o, &a0, 8);
        std::memcpy(o + 8, &a1, 8);
        o += 16;
        s += 16;
        k -= 16;
      } while (k > 0);
      return;
    }
    // short distance: seed one period, then double the copied window —
    // O(log len) memcpys instead of a per-byte loop
    for (int64_t i = 0; i < dist && i < len; ++i) op[i] = src[i];
    int64_t have = dist;
    while (have < len) {
      int64_t c = len - have < have ? len - have : have;
      std::memcpy(op + have, op, (size_t)c);
      have += c;
    }
    return;
  }
  for (int64_t k = 0; k < len; ++k) op[k] = src[k];
}

}  // namespace

// Decode one complete raw deflate stream (to BFINAL). Returns bytes
// written, or -1 on malformed input / overflow. Thread-safe, GIL-free.
// ``in_used`` (nullable) receives the INPUT bytes consumed through the
// final bit of BFINAL, rounded up to a byte — callers use it to detect
// trailing members a footer-scan mistook for payload (std gzip members
// have no declared compressed size; the reference has the same blind
// spot in findStdGzipFooter, qatzip_gzip.c:226-243, which we exceed).
int64_t qz_inflate_raw2(const uint8_t* src, int64_t n, uint8_t* dst,
                        int64_t cap, int64_t* in_used) {
  static bool ready = (init_static_tables(), true);
  (void)ready;
  BitIn in;
  in.init(src, n);
  uint8_t* op = dst;
  uint8_t* oend = dst + cap;
  static thread_local HuffTable* lit_tbl = new HuffTable;
  static thread_local HuffTable* dist_tbl = new HuffTable;
  int64_t result = -1;

  for (;;) {
    in.refill();
    uint32_t bfinal = in.get(1);
    uint32_t btype = in.get(2);
    if (in.overran()) goto done;
    if (btype == 0) {  // stored
      in.drop(in.nbits & 7);  // byte align
      if (in.overran()) goto done;
      // rewind: return whole buffered real bytes to the pointer domain
      while (in.pad > 0 && in.nbits >= 8) {
        in.nbits -= 8;
        --in.pad;
      }
      while (in.nbits >= 8) {
        in.nbits -= 8;
        --in.p;
      }
      in.bits = 0;
      if (in.p + 4 > in.end) goto done;
      uint32_t len = in.p[0] | (in.p[1] << 8);
      uint32_t nlen = in.p[2] | (in.p[3] << 8);
      if ((len ^ 0xFFFF) != nlen) goto done;
      in.p += 4;
      if (in.p + len > in.end || op + len > oend) goto done;
      std::memcpy(op, in.p, len);
      in.p += len;
      op += len;
    } else if (btype == 1 || btype == 2) {
      const HuffTable* lt;
      const HuffTable* dt;
      if (btype == 1) {
        lt = &g_static_lit;
        dt = &g_static_dist;
      } else {
        // dynamic: decode the code-length code (RFC1951 3.2.7)
        in.refill();
        uint32_t hlit = in.get(5) + 257;
        uint32_t hdist = in.get(5) + 1;
        uint32_t hclen = in.get(4) + 4;
        if (hlit > 288 || hdist > 32) goto done;
        static const uint8_t ord[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                        11, 4,  12, 3, 13, 2, 14, 1, 15};
        uint8_t cl_lens[19] = {0};
        for (uint32_t i = 0; i < hclen; ++i) {
          in.refill();
          cl_lens[ord[i]] = (uint8_t)in.get(3);
        }
        HuffTable cl_tbl;
        if (!build_table(cl_lens, 19, &cl_tbl)) goto done;
        uint8_t all[320] = {0};
        uint32_t idx = 0;
        while (idx < hlit + hdist) {
          int s = decode_sym(in, cl_tbl);
          if (s < 0 || in.overran()) goto done;
          if (s < 16) {
            all[idx++] = (uint8_t)s;
          } else if (s == 16) {
            if (idx == 0) goto done;
            in.refill();
            uint32_t r = 3 + in.get(2);
            if (idx + r > hlit + hdist) goto done;
            uint8_t v = all[idx - 1];
            while (r--) all[idx++] = v;
          } else if (s == 17) {
            in.refill();
            uint32_t r = 3 + in.get(3);
            if (idx + r > hlit + hdist) goto done;
            idx += r;
          } else {
            in.refill();
            uint32_t r = 11 + in.get(7);
            if (idx + r > hlit + hdist) goto done;
            idx += r;
          }
        }
        if (!build_table(all, (int)hlit, lit_tbl)) goto done;
        if (!build_table(all + hlit, (int)hdist, dist_tbl)) goto done;
        pack_entries(lit_tbl, true);
        pack_entries(dist_tbl, false);
        lt = lit_tbl;
        dt = dist_tbl;
      }
      // hot loop over PACKED entries: one table load yields the code
      // length AND the symbol's base/extra (or the literal byte) — no
      // auxiliary base-table loads on the match path
      for (;;) {
        in.refill();
        uint32_t e = resolve_packed(*lt, in.bits);
        // literal fast loop: one refill GUARANTEES three steps (3x15 =
        // 45 <= 56 buffered bits; a PAIR step consumes <= ROOT = 10),
        // so the per-literal nbits check disappears — refill only every
        // third step. Pair entries (0x10000000) write two bytes.
        // (Hoisting the output bound to one check per 3-step group was
        // measured 19% SLOWER at -O3 — the fatter loop body hurts more
        // than three predictable branches; tools/decprof.py.)
        while (e & 0x20000000u) {
          in.drop(e & 31);
          if (e & 0x10000000u) {
            if (op + 2 > oend) goto done;
            op[0] = (uint8_t)(e >> 8);
            op[1] = (uint8_t)(e >> 16);
            op += 2;
          } else {
            if (op >= oend) goto done;
            *op++ = (uint8_t)(e >> 8);
          }
          e = resolve_packed(*lt, in.bits);
          if (!(e & 0x20000000u)) break;
          in.drop(e & 31);
          if (e & 0x10000000u) {
            if (op + 2 > oend) goto done;
            op[0] = (uint8_t)(e >> 8);
            op[1] = (uint8_t)(e >> 16);
            op += 2;
          } else {
            if (op >= oend) goto done;
            *op++ = (uint8_t)(e >> 8);
          }
          e = resolve_packed(*lt, in.bits);
          if (!(e & 0x20000000u)) break;
          in.drop(e & 31);
          if (e & 0x10000000u) {
            if (op + 2 > oend) goto done;
            op[0] = (uint8_t)(e >> 8);
            op[1] = (uint8_t)(e >> 16);
            op += 2;
          } else {
            if (op >= oend) goto done;
            *op++ = (uint8_t)(e >> 8);
          }
          in.refill();
          e = resolve_packed(*lt, in.bits);
        }
        if (!e || in.overran()) goto done;
        in.drop(e & 31);
        if (e & 0x40000000u) break;   // EOB
        in.refill();   // 56+ bits cover len extra + dist code + dist extra
        int64_t len = (int64_t)((e >> 16) & 0x1FF) + in.get((e >> 5) & 15);
        uint32_t de = resolve_packed(*dt, in.bits);
        if (!de || in.overran()) goto done;
        in.drop(de & 31);
        int64_t dist = (int64_t)(de >> 16) + in.get((de >> 5) & 15);
        if (dist > op - dst || op + len > oend) goto done;
        copy_match(op, dist, len, oend);
        op += len;
      }
    } else {
      goto done;
    }
    if (bfinal) {
      if (in.overran()) goto done;
      result = (int64_t)(op - dst);
      goto done;
    }
  }
done:
  if (in_used) {
    int64_t bits = (int64_t)(in.p - src) * 8 - (in.nbits - in.pad * 8);
    *in_used = result >= 0 ? (bits + 7) / 8 : 0;
  }
  return result;   // lit_tbl/dist_tbl are thread_local, reused across calls
}

int64_t qz_inflate_raw(const uint8_t* src, int64_t n, uint8_t* dst,
                       int64_t cap) {
  return qz_inflate_raw2(src, n, dst, cap, nullptr);
}

// ---------------------------------------------------------------------------
// crc32 (zlib polynomial, reflected) — slicing-by-8, for the batch decoder
// ---------------------------------------------------------------------------
static uint32_t g_crc32_tbl[16][256];
static void init_crc32_tables() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0xEDB88320u & (~((c & 1) - 1)));
    g_crc32_tbl[0][i] = c;
  }
  for (int t = 1; t < 16; ++t)
    for (uint32_t i = 0; i < 256; ++i)
      g_crc32_tbl[t][i] = (g_crc32_tbl[t - 1][i] >> 8) ^
                          g_crc32_tbl[0][g_crc32_tbl[t - 1][i] & 0xFF];
}

// slicing-by-16 core over the INNER state (no pre/post inversion) — the
// tail/fallback engine behind qz_crc32 and the PCLMUL finalization
static uint32_t crc32_inner(const uint8_t* p, int64_t n, uint32_t crc) {
  while (n >= 16) {           // slicing-by-16 main loop
    uint32_t a, b, c, d;
    std::memcpy(&a, p, 4);
    std::memcpy(&b, p + 4, 4);
    std::memcpy(&c, p + 8, 4);
    std::memcpy(&d, p + 12, 4);
    a ^= crc;
    crc = g_crc32_tbl[15][a & 0xFF] ^ g_crc32_tbl[14][(a >> 8) & 0xFF] ^
          g_crc32_tbl[13][(a >> 16) & 0xFF] ^ g_crc32_tbl[12][a >> 24] ^
          g_crc32_tbl[11][b & 0xFF] ^ g_crc32_tbl[10][(b >> 8) & 0xFF] ^
          g_crc32_tbl[9][(b >> 16) & 0xFF] ^ g_crc32_tbl[8][b >> 24] ^
          g_crc32_tbl[7][c & 0xFF] ^ g_crc32_tbl[6][(c >> 8) & 0xFF] ^
          g_crc32_tbl[5][(c >> 16) & 0xFF] ^ g_crc32_tbl[4][c >> 24] ^
          g_crc32_tbl[3][d & 0xFF] ^ g_crc32_tbl[2][(d >> 8) & 0xFF] ^
          g_crc32_tbl[1][(d >> 16) & 0xFF] ^ g_crc32_tbl[0][d >> 24];
    p += 16;
    n -= 16;
  }
  while (n >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
    lo ^= crc;
    crc = g_crc32_tbl[7][lo & 0xFF] ^ g_crc32_tbl[6][(lo >> 8) & 0xFF] ^
          g_crc32_tbl[5][(lo >> 16) & 0xFF] ^ g_crc32_tbl[4][lo >> 24] ^
          g_crc32_tbl[3][hi & 0xFF] ^ g_crc32_tbl[2][(hi >> 8) & 0xFF] ^
          g_crc32_tbl[1][(hi >> 16) & 0xFF] ^ g_crc32_tbl[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n-- > 0) crc = (crc >> 8) ^ g_crc32_tbl[0][(crc ^ *p++) & 0xFF];
  return crc;
}

#if defined(__PCLMUL__) && defined(__SSE4_1__)
#include <wmmintrin.h>

// x^n mod G(x), G = the CRC-32 generator 0x104C11DB7, result bit i =
// coefficient of x^i (computed at init — no magic fold constants to
// mis-transcribe; the values match the published Intel/zlib tables)
static uint32_t crc32_xn_modg(int n) {
  uint32_t r = 1;  // x^0
  while (n--) {
    uint32_t hi = r & 0x80000000u;
    r <<= 1;
    if (hi) r ^= 0x04C11DB7u;
  }
  return r;
}

// carry-less multiplier for "multiply a bit-reflected polynomial by
// x^n mod G": with both operands bit-reflected, PCLMUL yields the
// reflected product >> 1; pre-shifting the constant left by 1 aligns it
static uint64_t crc32_fold_k(int n) {
  uint32_t t = crc32_xn_modg(n), r = 0;
  for (int i = 0; i < 32; ++i) r |= ((t >> i) & 1u) << (31 - i);
  return (uint64_t)r << 1;
}

// PCLMUL folding over 64-byte stripes (4 independent 128-bit
// accumulators), reflected domain. Invariant: the accumulator set
// represents a polynomial S with crc_state == (S*x^32 + tail) mod G, so
// the finalization needs NO Barrett step — store the final 16
// accumulator bytes and run the scalar slicing core over them (the
// bytes ARE the reflected representation of S). ~4-6x the slicing rate.
static uint32_t crc32_clmul(const uint8_t* p, int64_t n, uint32_t crc) {
  // the clmul of a register half by fold_k(n) represents A*(x^n)*x^32
  // in the register convention while the raw XORed-in block carries no
  // x^32 — so a fold by x^N uses exponents N+64-32 / N-32
  static const __m128i K512 =
      _mm_set_epi64x((long long)crc32_fold_k(480),
                     (long long)crc32_fold_k(544));
  static const __m128i K128 =
      _mm_set_epi64x((long long)crc32_fold_k(96),
                     (long long)crc32_fold_k(160));
  __m128i x0 = _mm_loadu_si128((const __m128i*)p);
  __m128i x1 = _mm_loadu_si128((const __m128i*)(p + 16));
  __m128i x2 = _mm_loadu_si128((const __m128i*)(p + 32));
  __m128i x3 = _mm_loadu_si128((const __m128i*)(p + 48));
  x0 = _mm_xor_si128(x0, _mm_cvtsi32_si128((int)crc));
  p += 64;
  n -= 64;
  while (n >= 64) {
    x0 = _mm_xor_si128(
        _mm_xor_si128(_mm_clmulepi64_si128(x0, K512, 0x00),
                      _mm_clmulepi64_si128(x0, K512, 0x11)),
        _mm_loadu_si128((const __m128i*)p));
    x1 = _mm_xor_si128(
        _mm_xor_si128(_mm_clmulepi64_si128(x1, K512, 0x00),
                      _mm_clmulepi64_si128(x1, K512, 0x11)),
        _mm_loadu_si128((const __m128i*)(p + 16)));
    x2 = _mm_xor_si128(
        _mm_xor_si128(_mm_clmulepi64_si128(x2, K512, 0x00),
                      _mm_clmulepi64_si128(x2, K512, 0x11)),
        _mm_loadu_si128((const __m128i*)(p + 32)));
    x3 = _mm_xor_si128(
        _mm_xor_si128(_mm_clmulepi64_si128(x3, K512, 0x00),
                      _mm_clmulepi64_si128(x3, K512, 0x11)),
        _mm_loadu_si128((const __m128i*)(p + 48)));
    p += 64;
    n -= 64;
  }
  // combine the 4 accumulators (each fold multiplies by x^128)
  __m128i y = x0;
  y = _mm_xor_si128(_mm_xor_si128(_mm_clmulepi64_si128(y, K128, 0x00),
                                  _mm_clmulepi64_si128(y, K128, 0x11)),
                    x1);
  y = _mm_xor_si128(_mm_xor_si128(_mm_clmulepi64_si128(y, K128, 0x00),
                                  _mm_clmulepi64_si128(y, K128, 0x11)),
                    x2);
  y = _mm_xor_si128(_mm_xor_si128(_mm_clmulepi64_si128(y, K128, 0x00),
                                  _mm_clmulepi64_si128(y, K128, 0x11)),
                    x3);
  while (n >= 16) {   // remaining whole 16-byte blocks
    y = _mm_xor_si128(_mm_xor_si128(_mm_clmulepi64_si128(y, K128, 0x00),
                                    _mm_clmulepi64_si128(y, K128, 0x11)),
                      _mm_loadu_si128((const __m128i*)p));
    p += 16;
    n -= 16;
  }
  uint8_t acc[16];
  _mm_storeu_si128((__m128i*)acc, y);
  return crc32_inner(p, n, crc32_inner(acc, 16, 0));
}

static bool crc32_clmul_selftest() {
  uint8_t buf[1031];
  uint32_t s = 0x9E3779B9u;
  for (size_t i = 0; i < sizeof(buf); ++i) {
    s = s * 1664525u + 1013904223u;
    buf[i] = (uint8_t)(s >> 24);
  }
  for (int64_t len : {64, 65, 128, 512, 1000, 1031})
    if (crc32_clmul(buf, len, 0x12345678u) !=
        crc32_inner(buf, len, 0x12345678u))
      return false;
  return true;
}
#endif  // __PCLMUL__

uint32_t qz_crc32(const uint8_t* p, int64_t n, uint32_t crc) {
  static bool ready = (init_crc32_tables(), true);
  (void)ready;
#if defined(__PCLMUL__) && defined(__SSE4_1__)
  static const bool clmul_ok = crc32_clmul_selftest();
  if (clmul_ok && n >= 64) return ~crc32_clmul(p, n, ~crc);
#endif
  return ~crc32_inner(p, n, ~crc);
}

// ---------------------------------------------------------------------------
// crc32_combine — GF(2) matrix form of "append len2 zero bytes" (the
// member-stitch crc fold, reference src/qatzip.c:1849 usage). The Python
// GF(2) loop cost ~13 ms per 768-member request; here the shift operator
// is built once per distinct member length and reused, so a whole batch
// folds in microseconds.
// ---------------------------------------------------------------------------
static uint32_t gf2_times(const uint32_t* mat, uint32_t vec) {
  uint32_t s = 0;
  for (int i = 0; vec; ++i, vec >>= 1)
    if (vec & 1) s ^= mat[i];
  return s;
}

static void gf2_square(uint32_t* dst, const uint32_t* src) {
  for (int i = 0; i < 32; ++i) dst[i] = gf2_times(src, src[i]);
}

// M <- operator for "multiply by x^(8*len)" (append len zero bytes)
static void crc32_shift_matrix(uint32_t* M, uint64_t len) {
  uint32_t pw[2][32];       // ping-pong powers: x^(2^k) bit shifts
  uint32_t acc[32], tmp[32];
  for (int i = 0; i < 32; ++i) acc[i] = 1u << i;   // identity
  pw[0][0] = 0xEDB88320u;                          // 1-bit shift (reflected)
  for (int i = 1; i < 32; ++i) pw[0][i] = 1u << (i - 1);
  int cur = 0;
  uint64_t nbits = len << 3;
  while (nbits) {
    if (nbits & 1) {
      for (int i = 0; i < 32; ++i) tmp[i] = gf2_times(pw[cur], acc[i]);
      std::memcpy(acc, tmp, sizeof(acc));
    }
    gf2_square(pw[cur ^ 1], pw[cur]);
    cur ^= 1;
    nbits >>= 1;
  }
  std::memcpy(M, acc, sizeof(acc));
}

// ---------------------------------------------------------------------------
// QZ-ext gzip member scan — the checkHeader walk (reference
// src/qatzip.c:2273-2369) specialized to the fixed 24-byte QZ-ext layout
// (qzGzipHeaderGen, src/qatzip_gzip.c:88): sizes ride the extra field, so
// the walk is pure pointer arithmetic. Returns the member count (filling
// the arrays up to ``cap``), or -1 if any header is not strict QZ-ext /
// truncated — the caller falls back to the general Python walk.
// *consumed = bytes covered by the parsed members.
// ---------------------------------------------------------------------------
static inline uint32_t rd_u32le(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;   // little-endian hosts only (x86/arm64 — build targets)
}

int64_t qz_scan_gzipext(const uint8_t* p, int64_t n, int64_t* pay_off,
                        int64_t* pay_len, int64_t* src_sz, uint32_t* crcs,
                        int64_t cap, int64_t* consumed) {
  int64_t off = 0, cnt = 0;
  while (off < n && cnt < cap) {
    if (n - off < 24 + 8) return -1;
    const uint8_t* h = p + off;
    if (h[0] != 0x1F || h[1] != 0x8B || h[2] != 8 || h[3] != 0x04)
      return -1;
    if ((h[8] != 0 && h[8] != 2 && h[8] != 4) || h[9] != 255) return -1;
    if (h[10] != 12 || h[11] != 0 || h[12] != 'Q' || h[13] != 'Z' ||
        h[14] != 8 || h[15] != 0)
      return -1;
    uint32_t ssz = rd_u32le(h + 16);
    uint32_t dsz = rd_u32le(h + 20);
    if (off + 24 + (int64_t)dsz + 8 > n) return -1;
    uint32_t fcrc = rd_u32le(h + 24 + dsz);
    uint32_t isize = rd_u32le(h + 24 + dsz + 4);
    if (isize != ssz) return -1;
    pay_off[cnt] = off + 24;
    pay_len[cnt] = dsz;
    src_sz[cnt] = ssz;
    crcs[cnt] = fcrc;
    ++cnt;
    off += 24 + dsz + 8;
  }
  *consumed = off;
  return cnt;
}

uint32_t qz_crc32_combine_many(const uint32_t* crcs, const int64_t* lens,
                               int32_t n, uint32_t init) {
  uint32_t acc = init;
  uint32_t M[32];
  int64_t cached = -1;
  for (int32_t i = 0; i < n; ++i) {
    if (lens[i] <= 0) continue;          // empty member: crc unchanged ^ 0
    if (lens[i] != cached) {
      crc32_shift_matrix(M, (uint64_t)lens[i]);
      cached = lens[i];
    }
    acc = gf2_times(M, acc) ^ crcs[i];
  }
  return acc;
}

// ---------------------------------------------------------------------------
// Batched member decode — the whole decompress hot loop in one GIL-free
// call: a member batch is decoded straight into a contiguous output by a
// native thread pool, with per-member crc32 for footer verification.
// This is the two-thread submit/poll pair of the reference
// (doDecompressIn/Out, src/qatzip.c:2374-2797) generalized to N workers.
// out_len[i] = decoded bytes, or -1 for a malformed member.
// ---------------------------------------------------------------------------
// Batched LZ4 block decode, native thread pool, GIL-free — the LZ4
// mirror of qz_inflate_batch (the reference decodes LZ4 members on
// silicon through the same submit/poll pair, src/qatzip.c:2374-2797).
// in_len[i] < 0 marks a STORED block: copy |in_len| source bytes
// verbatim (the frame's highest-bit-set block size case).
// ``crcs`` (nullable): per-block crc32 of the decoded bytes, computed
// while the block is cache-warm — the caller folds them with
// crc32_combine instead of re-reading the whole output (a full DRAM
// pass on large frames).
// ``xxh`` (nullable): xxh[0] in = seed, out = XXH32 of the whole decoded
// output; xxh[1] out = 1 when valid. Computed by a TRAILING thread that
// consumes blocks in order as decode workers finish them (L2-warm) —
// overlapping the frame content-checksum pass behind the decode instead
// of a separate full read afterwards. Valid only when every non-final
// block length is a positive multiple of 16 (the XXH32 stripe width), so
// the 4-lane phase stays aligned at block boundaries; otherwise xxh[1]=0
// and the caller hashes the output itself.
void qz_lz4_decompress_batch(const uint8_t* src, const int64_t* in_off,
                             const int64_t* in_len, uint8_t* dst,
                             const int64_t* out_off, const int64_t* out_cap,
                             int64_t* out_len, int32_t nblk,
                             int32_t nthreads, uint32_t* crcs,
                             uint32_t* xxh) {
  std::atomic<int32_t> next(0);
  std::unique_ptr<std::atomic<uint8_t>[]> done;
  if (xxh && nblk > 0) {
    done.reset(new std::atomic<uint8_t>[nblk]);
    for (int32_t i = 0; i < nblk; ++i)
      done[i].store(0, std::memory_order_relaxed);
  }
  auto worker = [&]() {
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= nblk) return;
      if (in_len[i] < 0) {
        int64_t sz = -in_len[i];
        if (sz > out_cap[i]) {
          out_len[i] = -1;
        } else {
          std::memcpy(dst + out_off[i], src + in_off[i], (size_t)sz);
          out_len[i] = sz;
        }
      } else {
        out_len[i] = qz_lz4_decompress_block(src + in_off[i], in_len[i],
                                             dst + out_off[i], out_cap[i]);
      }
      if (crcs)
        crcs[i] = out_len[i] >= 0
                      ? qz_crc32(dst + out_off[i], out_len[i], 0)
                      : 0;
      if (done) done[i].store(1, std::memory_order_release);
    }
  };
  auto hasher = [&]() {
    uint32_t seed = xxh[0];
    uint32_t a1 = seed + XP1 + XP2, a2 = seed + XP2, a3 = seed,
             a4 = seed - XP1;
    uint64_t total = 0;
    xxh[1] = 0;
    for (int32_t i = 0; i < nblk; ++i) {
      while (!done[i].load(std::memory_order_acquire))
        std::this_thread::yield();
      int64_t ln = out_len[i];
      if (ln < 0) return;                       // decode failed
      if (i + 1 < nblk && (ln == 0 || (ln & 15))) return;  // phase break
      const uint8_t* p = dst + out_off[i];
      const uint8_t* lim = p + (ln & ~(int64_t)15);
      while (p < lim) {
        a1 = rotl32(a1 + xread32(p) * XP2, 13) * XP1; p += 4;
        a2 = rotl32(a2 + xread32(p) * XP2, 13) * XP1; p += 4;
        a3 = rotl32(a3 + xread32(p) * XP2, 13) * XP1; p += 4;
        a4 = rotl32(a4 + xread32(p) * XP2, 13) * XP1; p += 4;
      }
      total += ln;
    }
    // finalize (the one-shot tail: <16 trailing bytes live in the LAST
    // block; every earlier block was a multiple of 16)
    uint32_t h;
    if (total >= 16) {
      h = rotl32(a1, 1) + rotl32(a2, 7) + rotl32(a3, 12) + rotl32(a4, 18);
    } else {
      h = seed + XP5;
    }
    h += (uint32_t)total;
    if (nblk > 0) {
      int64_t ln = out_len[nblk - 1];
      int64_t tail = total >= 16 ? (ln & 15) : ln;
      const uint8_t* p = dst + out_off[nblk - 1] + (ln - tail);
      const uint8_t* end = p + tail;
      while (p + 4 <= end) {
        h = rotl32(h + xread32(p) * XP3, 17) * XP4;
        p += 4;
      }
      while (p < end) {
        h = rotl32(h + (*p) * XP5, 11) * XP1;
        ++p;
      }
    }
    h ^= h >> 15; h *= XP2; h ^= h >> 13; h *= XP3; h ^= h >> 16;
    xxh[0] = h;
    xxh[1] = 1;
  };
  if (nthreads <= 1 || nblk <= 1) {
    worker();
    if (xxh && nblk > 0) hasher();
    else if (xxh) xxh[1] = 0;
    return;
  }
  int nt = nthreads < nblk ? nthreads : nblk;
  std::thread threads[64];
  if (nt > 64) nt = 64;
  if (xxh) {
    // The trailing hasher is a SEQUENTIAL critical path that must read
    // blocks while they are still cache-warm. Oversubscribed decode
    // workers starve it to a ~1/(nt+1) fair share, it falls behind the
    // decode wavefront, and the un-hashed tail is re-read from DRAM at
    // ~1/3 the warm rate (measured: 46 ms vs the 31 ms this cap gives
    // on the 48 MB bench frame). Leave the hasher one full core.
    unsigned hw = std::thread::hardware_concurrency();
    int cap = hw > 1 ? (int)hw - 1 : 1;
    if (nt > cap) nt = cap;
  }
  for (int t = 0; t < nt; ++t) threads[t] = std::thread(worker);
  std::thread hthread;
  if (xxh) hthread = std::thread(hasher);
  for (int t = 0; t < nt; ++t) threads[t].join();
  if (hthread.joinable()) hthread.join();
}

void qz_inflate_batch(const uint8_t* src, const int64_t* in_off,
                      const int64_t* in_len, uint8_t* dst,
                      const int64_t* out_off, const int64_t* out_cap,
                      int64_t* out_len, uint32_t* crcs, int32_t nmem,
                      int32_t nthreads, int64_t* in_used) {
  std::atomic<int32_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= nmem) return;
      int64_t r = qz_inflate_raw2(src + in_off[i], in_len[i],
                                  dst + out_off[i], out_cap[i],
                                  in_used ? &in_used[i] : nullptr);
      out_len[i] = r;
      crcs[i] = r >= 0 ? qz_crc32(dst + out_off[i], r, 0) : 0;
    }
  };
  if (nthreads <= 1 || nmem <= 1) {
    worker();
    return;
  }
  int nt = nthreads < nmem ? nthreads : nmem;
  std::thread threads[64];
  if (nt > 64) nt = 64;
  for (int t = 0; t < nt; ++t) threads[t] = std::thread(worker);
  for (int t = 0; t < nt; ++t) threads[t].join();
}

// ---------------------------------------------------------------------------
// Host LZ77 tokenizer — hash-4 chain matcher emitting the SAME packed
// token stream the device tokenizer produces (ops/lz77.py format), so the
// native entropy packers (qz_deflate_pack mode 0: best of stored/static/
// dynamic) turn it into final deflate bytes. This is the software codec's
// fast path: the reference's SW fallback is stock zlib (src/qatzip_sw.c);
// a dedicated matcher + the package-merge dynamic packer beats zlib L1 on
// both speed and ratio per core (measured; see engines.py).
//   match:       0x80000000 | len<<16 | (dist-1)
//   literal run: 0x40000000 | runlen (<= 16383)
// Thread-safe (thread_local tables), GIL-free.
// ---------------------------------------------------------------------------
}  // extern "C" — the matcher template below needs C++ linkage

namespace {
static const int HLOG = 16;
static inline uint32_t h4(const uint8_t* p) {
  uint32_t w;
  std::memcpy(&w, p, 4);
  return (w * 2654435761u) >> (32 - HLOG);
}
// common-prefix length of a vs b, up to maxlen (8-byte compares; a
// 32-byte AVX2 variant measured 167 vs 174 MB/s matcher rate — most
// matches are short, so wider loads don't save iterations)
static inline int match_len(const uint8_t* a, const uint8_t* b, int maxlen) {
  int k = 0;
  while (k + 8 <= maxlen) {
    uint64_t x, y;
    std::memcpy(&x, a + k, 8);
    std::memcpy(&y, b + k, 8);
    uint64_t d = x ^ y;
    if (d) return k + (__builtin_ctzll(d) >> 3);
    k += 8;
  }
  while (k < maxlen && a[k] == b[k]) ++k;
  return k;
}
}  // namespace

namespace {
// Matcher core, templated on the position type: 64 KB chunks (the
// default hw_buff_sz — the hot case) use uint16 tables, halving the
// head+prev cache footprint to 192 KB.
template <typename PosT>
static int64_t lz77_host_impl(const uint8_t* src, int64_t n, uint32_t* toks,
                              int64_t cap, int32_t chain, PosT* head,
                              PosT* prev) {

  int64_t t = 0, lit_start = 0;
  auto flush_lits = [&](int64_t upto) -> bool {
    while (lit_start < upto) {
      int64_t r = upto - lit_start;
      if (r > 16383) r = 16383;
      if (t >= cap) return false;
      toks[t++] = 0x40000000u | (uint32_t)r;
      lit_start += r;
    }
    return true;
  };

  int64_t pos = 0;
  const int64_t hash_end = n - 3;   // last position with 4 bytes to hash
  int64_t miss_run = 0;             // consecutive positions with no match
  while (pos < hash_end) {
    uint32_t h = h4(src + pos);
    int64_t cand = (int64_t)head[h];
    prev[pos] = head[h];
    head[h] = (PosT)pos;

    int best = 0;
    int64_t best_dist = 0;
    int maxlen = (int)((n - pos) < 258 ? (n - pos) : 258);
    int good = maxlen < 32 ? maxlen : 32;   // early-exit length
    uint32_t want;
    std::memcpy(&want, src + pos, 4);
    for (int32_t depth = 0; depth < chain; ++depth) {
      // terminator AND stale-entry guard: an empty bucket reads as
      // PosT(-1), and thread_local prev entries from an earlier chunk
      // may point anywhere — any cand >= pos ends the walk, and every
      // accepted candidate is verified by byte comparison below, so a
      // stale-but-smaller cand costs a probe, never a wrong token
      if (cand >= pos) break;
      if (pos - cand > 32768) break;
      // software-pipeline the walk: load the next chain link and give
      // its source bytes a prefetch head start before comparing this
      // candidate (the walk is a serial pointer chase otherwise)
      int64_t nextc = (int64_t)prev[cand];
      if (nextc < cand) __builtin_prefetch(src + nextc);
      uint32_t got;
      std::memcpy(&got, src + cand, 4);
      if (got == want) {
        int len = match_len(src + pos, src + cand, maxlen);
        if (len > best) {
          best = len;
          best_dist = pos - cand;
          if (len >= good) break;   // good-enough match — stop the chain
        }
      }
      cand = nextc;
    }
    if (best >= 4) {
      miss_run = 0;
      if (!flush_lits(pos) || t >= cap) return -1;
      toks[t++] = 0x80000000u | ((uint32_t)best << 16)
                  | (uint32_t)(best_dist - 1);
      // insert hashes across short matched spans only (the ratio case);
      // long spans skip insertion — zlib's max_insert_length idea
      int64_t end = pos + best;
      if (best <= 16) {
        for (int64_t q = pos + 1; q < end && q < hash_end; ++q) {
          uint32_t hq = h4(src + q);
          prev[q] = head[hq];
          head[hq] = (PosT)q;
        }
      }
      pos = end;
      lit_start = pos;
    } else {
      // literal-skip acceleration (snappy/LZ4-style): in regions with no
      // matches, probe-and-insert at a growing stride — incompressible
      // data approaches memcpy speed; the deflate token stream is
      // unaffected (skipped positions are literals either way) and a
      // fresh match region resets the stride. Inserting the skipped
      // positions was measured ratio-neutral (strided corpus included)
      // and halved incompressible throughput — rejected.
      ++miss_run;
      pos += 1 + (miss_run >> 6);
    }
  }
  if (!flush_lits(n)) return -1;
  return t;
}
// Lazy (deflate_slow-style) variant: a match at p is deferred one
// position; if p+1 holds a strictly longer match, p becomes a literal
// and the longer match wins. ~2x the chain walks of the greedy path for
// a few percent better ratio — the mid-level operating point.
template <typename PosT>
static int64_t lz77_host_lazy_impl(const uint8_t* src, int64_t n,
                                   uint32_t* toks, int64_t cap,
                                   int32_t chain, PosT* head, PosT* prev) {
  int64_t t = 0, lit_start = 0;
  auto flush_lits = [&](int64_t upto) -> bool {
    while (lit_start < upto) {
      int64_t r = upto - lit_start;
      if (r > 16383) r = 16383;
      if (t >= cap) return false;
      toks[t++] = 0x40000000u | (uint32_t)r;
      lit_start += r;
    }
    return true;
  };
  const int64_t hash_end = n - 3;
  auto find = [&](int64_t pos, int& best, int64_t& best_dist) {
    uint32_t h = h4(src + pos);
    int64_t cand = (int64_t)head[h];
    prev[pos] = head[h];
    head[h] = (PosT)pos;
    best = 0;
    best_dist = 0;
    int maxlen = (int)((n - pos) < 258 ? (n - pos) : 258);
    int good = maxlen < 64 ? maxlen : 64;
    uint32_t want;
    std::memcpy(&want, src + pos, 4);
    for (int32_t depth = 0; depth < chain; ++depth) {
      if (cand >= pos) break;          // empty/stale terminator (see above)
      if (pos - cand > 32768) break;
      // software-pipelined walk (same as the greedy matcher): +25%
      // at chain-16 on the mixed corpus, neutral at chain-4
      int64_t nextc = (int64_t)prev[cand];
      if (nextc < cand) __builtin_prefetch(src + nextc);
      uint32_t got;
      std::memcpy(&got, src + cand, 4);
      if (got == want) {
        int len = match_len(src + pos, src + cand, maxlen);
        if (len > best) {
          best = len;
          best_dist = pos - cand;
          if (len >= good) break;
        }
      }
      cand = nextc;
    }
  };

  int64_t pos = 0;
  int prev_best = 0;
  int64_t prev_dist = 0;               // deferred match found at pos-1
  while (pos < hash_end) {
    int best;
    int64_t best_dist;
    find(pos, best, best_dist);
    if (prev_best >= 4 && best <= prev_best) {
      // the deferred match at pos-1 stands
      if (!flush_lits(pos - 1) || t >= cap) return -1;
      toks[t++] = 0x80000000u | ((uint32_t)prev_best << 16)
                  | (uint32_t)(prev_dist - 1);
      int64_t end = pos - 1 + prev_best;
      if (prev_best <= 32) {           // pos already inserted; add the rest
        for (int64_t q = pos + 1; q < end && q < hash_end; ++q) {
          uint32_t hq = h4(src + q);
          prev[q] = head[hq];
          head[hq] = (PosT)q;
        }
      }
      pos = end;
      lit_start = pos;
      prev_best = 0;
      continue;
    }
    if (best >= 4) {
      prev_best = best;               // defer — pos+1 may hold better
      prev_dist = best_dist;
      ++pos;
      continue;
    }
    prev_best = 0;
    ++pos;
  }
  if (prev_best >= 4 && pos - 1 + prev_best <= n) {
    if (!flush_lits(pos - 1) || t >= cap) return -1;
    toks[t++] = 0x80000000u | ((uint32_t)prev_best << 16)
                | (uint32_t)(prev_dist - 1);
    lit_start = pos - 1 + prev_best;
  }
  if (!flush_lits(n)) return -1;
  return t;
}
}  // namespace

// One-call SW deflate compress for a whole chunk batch: match + pack +
// crc per chunk on a native thread pool, GIL-free — the entire
// qzSWCompress hot path (reference src/qatzip_sw.c:76-253) as one batch
// service, the compress mirror of qz_inflate_batch. Eliminates the
// per-chunk Python round-trips (3 calls + futures per chunk measured
// ~30% of the pooled path, tools/decprof.py era profiling).
// srcs[i]/lens[i] address each chunk (no contiguity requirement);
// out_len[i] = packed bytes at dst+dst_off[i], or -1 on overflow.
extern "C" int64_t qz_lz77_host(const uint8_t*, int64_t, uint32_t*,
                                int64_t, int32_t);
extern "C" void qz_deflate_compress_batch(
    const uint8_t* const* srcs, const int64_t* lens, const uint8_t* finals,
    int32_t chain, int32_t mode, uint8_t* dst, const int64_t* dst_off,
    const int64_t* dst_cap, int64_t* out_len, uint32_t* crcs,
    int32_t nchunks, int32_t nthreads) {
  std::atomic<int32_t> next(0);
  auto worker = [&]() {
    std::vector<uint32_t> toks;
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= nchunks) return;
      const uint8_t* p = srcs[i];
      int64_t n = lens[i];
      // token cap: worst case ~2 tokens per 5 bytes (1-literal run +
      // 4-byte match alternating) — n/2 + 64 is safely above it
      int64_t cap = n / 2 + 64;
      if ((int64_t)toks.size() < cap) toks.resize((size_t)cap);
      int64_t t = qz_lz77_host(p, n, toks.data(), cap, chain);
      if (t < 0) {
        out_len[i] = -1;
        crcs[i] = 0;
        continue;
      }
      out_len[i] = qz_deflate_pack(p, n, toks.data(), t, dst + dst_off[i],
                                   dst_cap[i], finals[i], mode);
      crcs[i] = qz_crc32(p, n, 0);
    }
  };
  if (nthreads <= 1 || nchunks <= 1) {
    worker();
    return;
  }
  int nt = nthreads < nchunks ? nthreads : nchunks;
  std::thread threads[64];
  if (nt > 64) nt = 64;
  for (int t = 0; t < nt; ++t) threads[t] = std::thread(worker);
  for (int t = 0; t < nt; ++t) threads[t].join();
}

// LZ4/LZ4s mirror of qz_deflate_compress_batch: whole chunk batch in one
// GIL-free call. fmt 0 = LZ4 block, 1 = LZ4s block (mini_match applies).
extern "C" int64_t qz_lz4_compress_block(const uint8_t*, int64_t, uint8_t*,
                                         int64_t, int32_t);
extern "C" int64_t qz_lz4s_compress_block(const uint8_t*, int64_t, uint8_t*,
                                          int64_t, int32_t, int32_t);
extern "C" void qz_lz4_compress_batch(
    const uint8_t* const* srcs, const int64_t* lens, int32_t fmt,
    int32_t mini_match, int32_t max_distance, uint8_t* dst,
    const int64_t* dst_off, const int64_t* dst_cap, int64_t* out_len,
    uint32_t* crcs, int32_t nchunks, int32_t nthreads) {
  std::atomic<int32_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= nchunks) return;
      const uint8_t* p = srcs[i];
      int64_t n = lens[i];
      out_len[i] =
          fmt ? qz_lz4s_compress_block(p, n, dst + dst_off[i], dst_cap[i],
                                       mini_match, max_distance)
              : qz_lz4_compress_block(p, n, dst + dst_off[i], dst_cap[i],
                                      max_distance);
      crcs[i] = qz_crc32(p, n, 0);
    }
  };
  if (nthreads <= 1 || nchunks <= 1) {
    worker();
    return;
  }
  int nt = nthreads < nchunks ? nthreads : nchunks;
  std::thread threads[64];
  if (nt > 64) nt = 64;
  for (int t = 0; t < nt; ++t) threads[t] = std::thread(worker);
  for (int t = 0; t < nt; ++t) threads[t].join();
}

// Returns token count, or -1 when cap is too small. chain = max hash-chain
// probes per position (4 ~ Pareto-above zlib L1-L3, 16+ ~ mid levels);
// negative chain = |chain| probes with LAZY evaluation (deflate_slow).
extern "C" int64_t qz_lz77_host(const uint8_t* src, int64_t n,
                                uint32_t* toks, int64_t cap, int32_t chain) {
  bool lazy = chain < 0;
  if (lazy) chain = -chain;
  if (n <= 65536) {
    // u16 tables; head/prev fit ~192 KB. PosT(-1)=65535 never collides
    // with a real insertion (max inserted pos is n-4 <= 65532).
    static thread_local std::vector<uint16_t> head16, prev16;
    if (head16.empty()) head16.resize((size_t)1 << HLOG);
    if ((int64_t)prev16.size() < n) prev16.resize(65536);
    std::memset(head16.data(), 0xFF, head16.size() * 2);
    return lazy ? lz77_host_lazy_impl<uint16_t>(src, n, toks, cap, chain,
                                                head16.data(), prev16.data())
                : lz77_host_impl<uint16_t>(src, n, toks, cap, chain,
                                           head16.data(), prev16.data());
  }
  static thread_local std::vector<uint32_t> head32, prev32;
  if (head32.empty()) head32.resize((size_t)1 << HLOG);
  if ((int64_t)prev32.size() < n) prev32.resize((size_t)n);
  std::memset(head32.data(), 0xFF, head32.size() * 4);
  return lazy ? lz77_host_lazy_impl<uint32_t>(src, n, toks, cap, chain,
                                              head32.data(), prev32.data())
              : lz77_host_impl<uint32_t>(src, n, toks, cap, chain,
                                         head32.data(), prev32.data());
}
