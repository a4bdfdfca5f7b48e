// fl_codec: LZ4-block-format compressor/decompressor.
//
// First-party native tier of the compression service (the reference fills
// this slot with the third-party lz4 wheel, src/shared/compression.py:62-122;
// this environment has no lz4, so the codec is implemented here). Standard
// LZ4 block format: greedy matcher over a 4-byte hash chain, 64 KB window,
// token/literal/offset/matchlen sequences. Framing (magic + original size)
// is done by the Python wrapper.
//
// Build: g++ -O3 -shared -fPIC fl_codec.cpp -o libflcodec.so
// (driven by fl_tpu/native/__init__.py at first import).

#include <cstdint>
#include <cstring>

namespace {

constexpr int kMinMatch = 4;
constexpr int kHashBits = 16;
constexpr int kHashSize = 1 << kHashBits;
constexpr int kMaxOffset = 65535;
// LZ4 spec: the last match must start at least 12 bytes before the end of
// the block, and the last 5 bytes are always literals.
constexpr int kLastLiterals = 5;
constexpr int kMfLimit = 12;

inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint32_t hash4(uint32_t v) {
  return (v * 2654435761u) >> (32 - kHashBits);
}

// emit a length in LZ4's 255-continuation encoding
inline uint8_t* write_length(uint8_t* op, int len) {
  while (len >= 255) {
    *op++ = 255;
    len -= 255;
  }
  *op++ = static_cast<uint8_t>(len);
  return op;
}

}  // namespace

extern "C" {

// worst-case compressed size for a given input size (LZ4_compressBound)
int fl_lz4_bound(int src_len) {
  return src_len + src_len / 255 + 16;
}

// returns compressed size, or -1 if dst is too small / input invalid
int fl_lz4_compress(const uint8_t* src, int src_len, uint8_t* dst,
                    int dst_cap) {
  if (src_len < 0 || dst_cap < fl_lz4_bound(src_len)) return -1;

  const uint8_t* ip = src;
  const uint8_t* const iend = src + src_len;
  const uint8_t* const mflimit = iend - kMfLimit;
  const uint8_t* anchor = src;
  uint8_t* op = dst;

  if (src_len >= kMinMatch + kLastLiterals) {
    // hash table of absolute positions (offset-from-src + 1; 0 = empty)
    static thread_local uint32_t table[kHashSize];
    std::memset(table, 0, sizeof(table));

    // skip acceleration (standard LZ4 heuristic): after repeated failed
    // probes, stride through incompressible regions faster
    int search_failures = 0;

    while (ip < mflimit) {
      uint32_t h = hash4(load32(ip));
      uint32_t candidate_pos = table[h];
      table[h] = static_cast<uint32_t>(ip - src) + 1;

      const uint8_t* match = nullptr;
      if (candidate_pos != 0) {
        const uint8_t* cand = src + candidate_pos - 1;
        if (ip - cand <= kMaxOffset && load32(cand) == load32(ip)) {
          match = cand;
        }
      }
      if (match == nullptr) {
        ip += 1 + (search_failures++ >> 6);
        continue;
      }
      search_failures = 0;

      // extend the match forward
      const uint8_t* m = match + kMinMatch;
      const uint8_t* i2 = ip + kMinMatch;
      const uint8_t* const matchlimit = iend - kLastLiterals;
      while (i2 < matchlimit && *i2 == *m) {
        ++i2;
        ++m;
      }
      int match_len = static_cast<int>(i2 - ip);  // >= kMinMatch
      int literal_len = static_cast<int>(ip - anchor);
      int offset = static_cast<int>(ip - match);

      // classic heuristic: minimum-length matches at far offsets gain
      // almost nothing and dominate runtime on near-incompressible data
      if (match_len == kMinMatch && offset > 8192) {
        ip += 1 + (search_failures++ >> 6);
        continue;
      }

      // token
      uint8_t* token = op++;
      if (literal_len >= 15) {
        *token = 15 << 4;
        op = write_length(op, literal_len - 15);
      } else {
        *token = static_cast<uint8_t>(literal_len << 4);
      }
      std::memcpy(op, anchor, literal_len);
      op += literal_len;

      // offset (little endian)
      *op++ = static_cast<uint8_t>(offset & 0xFF);
      *op++ = static_cast<uint8_t>((offset >> 8) & 0xFF);

      int ml_code = match_len - kMinMatch;
      if (ml_code >= 15) {
        *token |= 15;
        op = write_length(op, ml_code - 15);
      } else {
        *token |= static_cast<uint8_t>(ml_code);
      }

      ip += match_len;
      anchor = ip;
    }
  }

  // final literal-only sequence
  int last_literals = static_cast<int>(iend - anchor);
  uint8_t* token = op++;
  if (last_literals >= 15) {
    *token = 15 << 4;
    op = write_length(op, last_literals - 15);
  } else {
    *token = static_cast<uint8_t>(last_literals << 4);
  }
  std::memcpy(op, anchor, last_literals);
  op += last_literals;

  return static_cast<int>(op - dst);
}

// returns decompressed size, or -1 on malformed input / overflow
//
// Lengths accumulate in int64_t and every bound compares lengths against
// remaining space (never `ptr + len > end`, which overflows the pointer —
// UB — once a hostile stream stacks enough 0xFF continuation bytes). An
// accumulated length can never validly exceed dst_cap (output side) or the
// remaining input, so each continuation loop also bails as soon as the
// length passes a hard cap — bounding both the loop and the accumulator on
// attacker-controlled payloads (compressed client updates are untrusted
// input to the coordinator's compression service).
int fl_lz4_decompress(const uint8_t* src, int src_len, uint8_t* dst,
                      int dst_cap) {
  if (src_len < 0 || dst_cap < 0) return -1;
  const uint8_t* ip = src;
  const uint8_t* const iend = src + src_len;
  uint8_t* op = dst;
  uint8_t* const oend = dst + dst_cap;
  const int64_t len_cap = static_cast<int64_t>(dst_cap);

  while (ip < iend) {
    uint8_t token = *ip++;

    // literals
    int64_t literal_len = token >> 4;
    if (literal_len == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        literal_len += b;
        if (literal_len > len_cap) return -1;
      } while (b == 255);
    }
    if (literal_len > iend - ip || literal_len > oend - op) return -1;
    std::memcpy(op, ip, static_cast<size_t>(literal_len));
    ip += literal_len;
    op += literal_len;

    if (ip >= iend) break;  // final literal-only sequence

    // match
    if (iend - ip < 2) return -1;
    int offset = ip[0] | (ip[1] << 8);
    ip += 2;
    if (offset == 0 || op - dst < offset) return -1;

    int64_t match_len = (token & 0x0F) + kMinMatch;
    if ((token & 0x0F) == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        match_len += b;
        if (match_len > len_cap) return -1;
      } while (b == 255);
    }
    if (match_len > oend - op) return -1;
    const uint8_t* match = op - offset;
    // byte-wise copy: overlapping matches are the RLE case and must copy
    // forward one byte at a time
    for (int64_t i = 0; i < match_len; ++i) op[i] = match[i];
    op += match_len;
  }
  return static_cast<int>(op - dst);
}

}  // extern "C"
