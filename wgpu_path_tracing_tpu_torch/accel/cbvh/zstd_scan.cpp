// wpt_zstd: Zstandard frame decoding (RFC 8878) as libzstd 1.5.7 decodes
// it, the same bytes and refusals as utils/zstd.py::zstd_plain, its plain
// version (that module's docstring says what is checked). With limit < 0
// it is ZSTD_decompress on every frame of the data; with limit >= 0 it is
// what libtiff's ZSTDDecode gets out of ZSTD_decompressStream with limit
// bytes of room (the first frame, stopped after the first block whose
// output does not fit, or where the data ends), cut to limit bytes.
// Status: 0 decoded; 1 refused; 2 the output needs more than cap bytes
// (out_len says how many: call again).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Refused {};
struct Short {};  // the data ends before the frame does

const uint32_t kMagic = 0xFD2FB528u;
const int64_t kBlockSizeMax = 1 << 17;
const int64_t kStreamWindowMax = (int64_t(1) << 27) + 1;
const int kHufTableLogMax = 12;

const int32_t kLLBase[36] = {
    0,  1,  2,   3,   4,   5,   6,    7,    8,    9,     10,    11,
    12, 13, 14,  15,  16,  18,  20,   22,   24,   28,    32,    40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const int32_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,  15,   16,   17,
    18, 19, 20, 21, 22, 23, 24, 25, 26, 27,  28,  29,  30,   31,   32,
    33, 34, 35, 37, 39, 41, 43, 47, 51, 59,  67,  83,  99,   131,  259,
    515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const int32_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1,
                                -1};
// HUF_selectDecoder's (table, decode256) timings for X1 and X2 by ratio.
const uint32_t kAlgoTime[16][2][2] = {
    {{0, 0}, {1, 1}},         {{0, 0}, {1, 1}},
    {{150, 216}, {381, 119}}, {{170, 205}, {514, 112}},
    {{177, 199}, {539, 110}}, {{197, 194}, {644, 107}},
    {{221, 192}, {735, 107}}, {{256, 189}, {881, 106}},
    {{359, 188}, {1167, 109}}, {{582, 187}, {1570, 114}},
    {{688, 187}, {1712, 122}}, {{825, 186}, {1965, 136}},
    {{976, 185}, {2131, 150}}, {{1180, 186}, {2070, 175}},
    {{1377, 185}, {1731, 202}}, {{1412, 185}, {1695, 202}}};

inline int bit_length(uint64_t v) { return v ? 64 - __builtin_clzll(v) : 0; }

inline uint64_t load_le(const uint8_t* d, int64_t n, int64_t at, int k) {
  uint64_t v = 0;
  for (int i = 0; i < k; ++i)
    if (at + i < n) v |= uint64_t(d[at + i]) << (8 * i);
  return v;
}

// XXH64 (the content checksum keeps its low 32 bits).
const uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
               P3 = 1609587929392839161ull, P4 = 9650029242287828579ull,
               P5 = 2870177450012600261ull;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t lane) {
  return rotl(acc + lane * P2, 31) * P1;
}
uint64_t xxh64(const uint8_t* p, int64_t n) {
  int64_t i = 0;
  uint64_t h;
  if (n >= 32) {
    uint64_t v[4] = {P1 + P2, P2, 0, 0 - P1};
    for (; i + 32 <= n; i += 32)
      for (int k = 0; k < 4; ++k) v[k] = xround(v[k], load_le(p, n, i + 8 * k, 8));
    h = rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18);
    for (int k = 0; k < 4; ++k) h = (h ^ xround(0, v[k])) * P1 + P4;
  } else {
    h = P5;
  }
  h += uint64_t(n);
  for (; i + 8 <= n; i += 8) h = rotl(h ^ xround(0, load_le(p, n, i, 8)), 27) * P1 + P4;
  if (i + 4 <= n) {
    h = rotl(h ^ (load_le(p, n, i, 4) * P1), 23) * P2 + P3;
    i += 4;
  }
  for (; i < n; ++i) h = rotl(h ^ (uint64_t(p[i]) * P5), 11) * P1;
  h = (h ^ (h >> 33)) * P2;
  h = (h ^ (h >> 29)) * P3;
  return h ^ (h >> 32);
}

// A backward bitstream: bits past the start read as 0, left goes negative.
struct Back {
  const uint8_t* d;
  int64_t n;
  int64_t left;
  Back(const uint8_t* data, int64_t size) : d(data), n(size) {
    if (size <= 0 || data[size - 1] == 0) throw Refused();
    left = 8 * (size - 1) + bit_length(data[size - 1]) - 1;
  }
  uint64_t peek(int nb) const {
    if (nb == 0) return 0;
    int64_t p = left - nb;
    if (p >= 0) {
      uint64_t v = load_le(d, n, p >> 3, 8) >> (p & 7);
      return v & ((uint64_t(1) << nb) - 1);
    }
    int64_t top = p + nb;
    if (top <= 0) return 0;
    uint64_t v = load_le(d, n, 0, 8) & ((uint64_t(1) << top) - 1);
    return v << (-p);
  }
  uint64_t read(int nb) {
    uint64_t v = peek(nb);
    left -= nb;
    return v;
  }
};

// FSE_readNCount on src[pos, end): counts, accuracy log; returns bytes read.
int64_t read_ncount(const uint8_t* src, int64_t pos, int64_t end,
                    int max_symbol, std::vector<int16_t>& counts, int& log) {
  int64_t size = end - pos;
  if (size < 8) {
    uint8_t buf[8] = {0};
    std::memcpy(buf, src + pos, size_t(size));
    int64_t used = read_ncount(buf, 0, 8, max_symbol, counts, log);
    if (used > size) throw Refused();
    return used;
  }
  const int64_t iend = end;
  int64_t ip = pos;
  int max1 = max_symbol + 1;
  std::vector<int16_t> norm(size_t(max1), 0);
  auto word = [&](int64_t at) { return uint32_t(load_le(src, end, at, 4)); };
  uint32_t bits = word(ip);
  int nb = int(bits & 15) + 5;
  if (nb > 15) throw Refused();
  log = nb;
  bits >>= 4;
  int count_bits = 4;
  int remaining = (1 << nb) + 1;
  int threshold = 1 << nb;
  nb += 1;
  int charnum = 0;
  bool previous0 = false;
  auto advance = [&]() {
    if (ip <= iend - 7 || ip + (count_bits >> 3) <= iend - 4) {
      ip += count_bits >> 3;
      count_bits &= 7;
    } else {
      count_bits -= int(8 * (iend - 4 - ip));
      count_bits &= 31;
      ip = iend - 4;
    }
    bits = word(ip) >> count_bits;
  };
  for (;;) {
    if (previous0) {
      int repeats = __builtin_ctz(~bits | 0x80000000u) >> 1;
      while (repeats >= 12) {
        charnum += 36;
        if (ip <= iend - 7) {
          ip += 3;
        } else {
          count_bits -= int(8 * (iend - 7 - ip));
          count_bits &= 31;
          ip = iend - 4;
        }
        bits = word(ip) >> count_bits;
        repeats = __builtin_ctz(~bits | 0x80000000u) >> 1;
      }
      charnum += 3 * repeats;
      bits >>= 2 * repeats;
      count_bits += 2 * repeats;
      charnum += int(bits & 3);
      count_bits += 2;
      if (charnum >= max1) break;
      advance();
    }
    int mx = (2 * threshold - 1) - remaining;
    int count;
    if (int(bits & uint32_t(threshold - 1)) < mx) {
      count = int(bits & uint32_t(threshold - 1));
      count_bits += nb - 1;
    } else {
      count = int(bits & uint32_t(2 * threshold - 1));
      if (count >= threshold) count -= mx;
      count_bits += nb;
    }
    count -= 1;
    remaining -= count >= 0 ? count : -count;
    norm[size_t(charnum++)] = int16_t(count);
    previous0 = count == 0;
    if (remaining < threshold) {
      if (remaining <= 1) break;
      nb = bit_length(uint64_t(remaining));
      threshold = 1 << (nb - 1);
    }
    if (charnum >= max1) break;
    advance();
  }
  if (remaining != 1 || charnum > max1 || count_bits > 32) throw Refused();
  counts.assign(norm.begin(), norm.begin() + charnum);
  return ip + ((count_bits + 7) >> 3) - pos;
}

struct FseCell {
  int32_t symbol, nb, base;
};

std::vector<FseCell> fse_table(const int16_t* counts, int n, int log) {
  int size = 1 << log, high = size - 1;
  std::vector<int32_t> table(size_t(size), 0), nxt(size_t(n), 0);
  for (int s = 0; s < n; ++s) {
    if (counts[s] == -1) {
      table[size_t(high--)] = s;
      nxt[size_t(s)] = 1;
    } else {
      nxt[size_t(s)] = counts[s];
    }
  }
  int step = (size >> 1) + (size >> 3) + 3, pos = 0;
  for (int s = 0; s < n; ++s)
    for (int i = 0; i < counts[s]; ++i) {
      table[size_t(pos)] = s;
      pos = (pos + step) & (size - 1);
      while (pos > high) pos = (pos + step) & (size - 1);
    }
  std::vector<FseCell> out(static_cast<size_t>(size));
  for (int u = 0; u < size; ++u) {
    int s = table[size_t(u)];
    int x = nxt[size_t(s)]++;
    int nb = log - (bit_length(uint64_t(x)) - 1);
    out[size_t(u)] = {s, nb, (x << nb) - size};
  }
  return out;
}

// FSE_decompress_wksp of Huffman weights: two states until the stream ends.
std::vector<int> fse_weights(const uint8_t* src, int64_t pos, int64_t end) {
  std::vector<int16_t> counts;
  int log = 0;
  int64_t used = read_ncount(src, pos, end, 255, counts, log);
  if (log > 6) throw Refused();
  std::vector<FseCell> table = fse_table(counts.data(), int(counts.size()), log);
  Back bs(src + pos + used, end - pos - used);
  int64_t s1 = int64_t(bs.read(log)), s2 = int64_t(bs.read(log));
  std::vector<int> out;
  for (;;) {
    if (out.size() > 253) throw Refused();
    FseCell c = table[size_t(s1)];
    out.push_back(c.symbol);
    s1 = c.base + int64_t(bs.read(c.nb));
    if (bs.left < 0) {
      out.push_back(table[size_t(s2)].symbol);
      break;
    }
    if (out.size() > 253) throw Refused();
    c = table[size_t(s2)];
    out.push_back(c.symbol);
    s2 = c.base + int64_t(bs.read(c.nb));
    if (bs.left < 0) {
      out.push_back(table[size_t(s1)].symbol);
      break;
    }
  }
  return out;
}

struct Huf {
  std::vector<uint8_t> sym, len;  // a (symbol, code length) per log bits
  int log = 0;
  bool x2 = false;
};

// HUF_readStats: each symbol's weight (the last one implied); bytes read.
int64_t huf_weights(const uint8_t* src, int64_t pos, int64_t end,
                    std::vector<int>& weights) {
  if (pos >= end) throw Refused();
  int head = src[pos];
  int64_t size;
  if (head >= 128) {
    int n = head - 127;
    size = (n + 1) / 2;
    if (size + 1 > end - pos) throw Refused();
    weights.clear();
    for (int i = 0; i < n; ++i) {
      int b = src[pos + 1 + i / 2];
      weights.push_back(i % 2 == 0 ? b >> 4 : b & 15);
    }
  } else {
    size = head;
    if (size + 1 > end - pos) throw Refused();
    weights = fse_weights(src, pos + 1, pos + 1 + size);
  }
  int rank[kHufTableLogMax + 2] = {0};
  uint64_t total = 0;
  for (int w : weights) {
    if (w > kHufTableLogMax) throw Refused();
    rank[w] += 1;
    total += (uint64_t(1) << w) >> 1;
  }
  if (total == 0) throw Refused();
  int log = bit_length(total);
  if (log > kHufTableLogMax) throw Refused();
  uint64_t rest = (uint64_t(1) << log) - total;
  int last = bit_length(rest);
  if ((uint64_t(1) << (last - 1)) != rest) throw Refused();
  weights.push_back(last);
  rank[last] += 1;
  if (rank[1] < 2 || (rank[1] & 1)) throw Refused();
  return size + 1;
}

Huf huf_table(const std::vector<int>& weights, bool x2) {
  uint64_t total = 0;
  for (int w : weights) total += (uint64_t(1) << w) >> 1;
  Huf h;
  h.log = bit_length(total) - 1;
  h.x2 = x2;
  h.sym.assign(size_t(1) << h.log, 0);
  h.len.assign(size_t(1) << h.log, 0);
  std::vector<int64_t> start(size_t(h.log + 2), 0);
  int64_t nxt = 0;
  for (int w = 1; w <= h.log; ++w) {
    start[size_t(w)] = nxt;
    int64_t c = 0;
    for (int x : weights) c += x == w;
    nxt += c << (w - 1);
  }
  for (size_t s = 0; s < weights.size(); ++s) {
    int w = weights[s];
    if (!w) continue;
    int64_t n = (int64_t(1) << w) >> 1;
    for (int64_t k = 0; k < n; ++k) {
      h.sym[size_t(start[size_t(w)] + k)] = uint8_t(s);
      h.len[size_t(start[size_t(w)] + k)] = uint8_t(h.log + 1 - w);
    }
    start[size_t(w)] += n;
  }
  return h;
}

bool select_x2(int64_t dst, int64_t src) {
  int q = src >= dst ? 15 : int(src * 16 / dst);
  if (q < 2) return false;
  uint64_t d256 = uint64_t(dst) >> 8;
  uint64_t t0 = kAlgoTime[q][0][0] + kAlgoTime[q][0][1] * d256;
  uint64_t t1 = kAlgoTime[q][1][0] + kAlgoTime[q][1][1] * d256;
  return t1 + (t1 >> 5) < t0;
}

// The double-symbol table's entry for the next target bits v.
void x2_entry(const Huf& h, int target, uint64_t v, int& s1, int& l1,
              int& s2, int& l2) {
  size_t i1 = size_t(v >> (target - h.log));
  s1 = h.sym[i1];
  l1 = h.len[i1];
  int rem = target - l1;
  uint64_t v2 = v & ((uint64_t(1) << rem) - 1);
  size_t i2 = size_t(rem >= h.log ? v2 >> (rem - h.log) : v2 << (h.log - rem));
  s2 = h.sym[i2];
  l2 = h.len[i2] <= rem ? h.len[i2] : -1;
}

void huf_stream(const uint8_t* data, int64_t n, int64_t count, const Huf& h,
                std::vector<uint8_t>& out) {
  Back bs(data, n);
  if (!h.x2) {
    for (int64_t i = 0; i < count; ++i) {
      size_t v = size_t(bs.peek(h.log));
      out.push_back(h.sym[v]);
      bs.left -= h.len[v];
    }
  } else {
    int target = h.log > 11 ? h.log : 11;
    int s1, l1, s2, l2;
    int64_t i = 0;
    while (i <= count - 2) {
      x2_entry(h, target, bs.peek(target), s1, l1, s2, l2);
      out.push_back(uint8_t(s1));
      if (l2 < 0) {
        bs.left -= l1;
        i += 1;
      } else {
        out.push_back(uint8_t(s2));
        bs.left -= l1 + l2;
        i += 2;
      }
    }
    if (i < count) {
      uint64_t v = bs.left ? bs.peek(target)
                           : load_le(data, n, 0, 8) >> (64 - target);
      x2_entry(h, target, v, s1, l1, s2, l2);
      out.push_back(uint8_t(s1));
      if (l2 < 0) {
        bs.left -= l1;
      } else if (bs.left > 0) {
        bs.left -= l1 + l2;
        if (bs.left < 0) bs.left = 0;
      }
    }
  }
  if (bs.left != 0) throw Refused();
}

// The 11 bits under bit r of mem (zeros below bit 0), as the fast
// decoders' registers hold them; at or below bit 0 the register stays on
// the first 8 bytes and its shift wraps (bitsConsumed & 63).
uint32_t fast_peek(const uint8_t* mem, int64_t n, int64_t r) {
  if (r <= 0) r = ((r - 1) % 64 + 64) % 64 + 1;
  int64_t p = r - 11;
  if (p >= 0) return uint32_t(load_le(mem, n, p >> 3, 8) >> (p & 7)) & 0x7FF;
  return uint32_t((load_le(mem, n, 0, 8) & ((uint64_t(1) << r) - 1)) << -p);
}

// libzstd's fast four-stream decoders (utils/zstd.py::_huf_fast).
void huf_fast(const uint8_t* mem, int64_t n, const int64_t* lens, int64_t lit,
              const Huf& h, std::vector<uint8_t>& lits) {
  int64_t seg = (lit + 3) / 4;
  int64_t counts[4] = {seg, seg, seg, lit - 3 * seg};
  int64_t starts[4], r[4], ip[4];
  starts[0] = 6;
  for (int k = 1; k < 4; ++k) starts[k] = starts[k - 1] + lens[k - 1];
  for (int k = 0; k < 4; ++k) {
    int64_t e = starts[k] + lens[k];
    int last = mem[e - 1];
    r[k] = 8 * e - (last ? 9 - bit_length(uint64_t(last)) : 0);
    ip[k] = e - 8;
  }
  std::vector<uint8_t> outs[4];
  auto entry = [&](int k, uint8_t* syms, int& count) {
    uint32_t v = fast_peek(mem, n, r[k]);
    if (!h.x2) {
      size_t i = size_t(v >> (11 - h.log));
      syms[0] = h.sym[i];
      count = 1;
      return int(h.len[i]);
    }
    int s1, l1, s2, l2;
    x2_entry(h, 11, v, s1, l1, s2, l2);
    syms[0] = uint8_t(s1);
    if (l2 < 0) {
      count = 1;
      return l1;
    }
    syms[1] = uint8_t(s2);
    count = 2;
    return l1 + l2;
  };
  uint8_t syms[2];
  int count;
  for (;;) {
    int64_t iters = ip[0] / 7;
    if (h.x2) {
      for (int k = 0; k < 4; ++k) {
        int64_t o = (counts[k] - int64_t(outs[k].size())) / 10;
        if (o < iters) iters = o;
      }
    } else {
      int64_t o = (counts[3] - int64_t(outs[3].size())) / 5;
      if (o < iters) iters = o;
    }
    if (iters == 0 || ip[1] < ip[0] || ip[2] < ip[1] || ip[3] < ip[2]) break;
    int64_t olimit = int64_t(outs[3].size()) + 5 * iters;
    while (int64_t(outs[3].size()) < olimit) {
      for (int k = 0; k < 4; ++k) {
        for (int j = 0; j < 5; ++j) {
          r[k] -= entry(k, syms, count);
          outs[k].insert(outs[k].end(), syms, syms + count);
        }
        ip[k] = -((64 - r[k]) >> 3);  // ceil((r - 64) / 8)
      }
    }
  }
  for (int k = 0; k < 4; ++k) {
    if (ip[k] < starts[k] - 8) throw Refused();
    while (int64_t(outs[k].size()) < counts[k]) {
      r[k] -= entry(k, syms, count);
      int64_t left = counts[k] - int64_t(outs[k].size());
      outs[k].insert(outs[k].end(), syms, syms + (count < left ? count : left));
    }
    lits.insert(lits.end(), outs[k].begin(), outs[k].end());
  }
}

struct SeqCell {
  int32_t base, bits, nb, next;
};

struct Frame {
  int64_t block_max;
  Huf huf;
  bool has_huf = false;
  std::vector<SeqCell> tables[3];
  bool has_table[3] = {false, false, false};
  int64_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> out;
};

// ZSTD_decodeLiteralsBlock: the literals; returns bytes read.
int64_t literals(Frame& f, const uint8_t* src, int64_t pos, int64_t end,
                 std::vector<uint8_t>& lits) {
  int64_t size = end - pos;
  if (size < 2) throw Refused();
  int b0 = src[pos], kind = b0 & 3, fmt = (b0 >> 2) & 3;
  lits.clear();
  if (kind <= 1) {
    static const int kHead[4] = {1, 2, 1, 3};
    int head = kHead[fmt];
    if (size < head + (kind == 1 && head > 1)) throw Refused();
    int64_t lit = int64_t(load_le(src, end, pos, head) >> (head == 1 ? 3 : 4));
    if (lit > f.block_max) throw Refused();
    if (kind == 0) {
      if (head + lit > size) throw Refused();
      lits.assign(src + pos + head, src + pos + head + lit);
      return head + lit;
    }
    lits.assign(size_t(lit), src[pos + head]);
    return head + 1;
  }
  if (size < 5) throw Refused();
  uint64_t hd = load_le(src, end, pos, 5);
  bool single = fmt == 0;
  int head;
  int64_t lit, csize;
  if (fmt <= 1) {
    head = 3, lit = (hd >> 4) & 0x3FF, csize = (hd >> 14) & 0x3FF;
  } else if (fmt == 2) {
    head = 4, lit = (hd >> 4) & 0x3FFF, csize = (hd >> 18) & 0x3FFF;
  } else {
    head = 5, lit = (hd >> 4) & 0x3FFFF, csize = (hd >> 22) & 0x3FFFF;
  }
  if (lit > f.block_max) throw Refused();
  if (!single && lit < 6) throw Refused();
  if (csize + head > size) throw Refused();
  int64_t at = pos + head, stop = pos + head + csize;
  Huf built;
  const Huf* huf;
  if (kind == 3) {
    if (!f.has_huf) throw Refused();
    huf = &f.huf;
  } else {
    std::vector<int> weights;
    at += huf_weights(src, at, stop, weights);
    if (at >= stop) throw Refused();
    built = huf_table(weights, !single && select_x2(lit, csize));
    huf = &built;
  }
  if (single) {
    huf_stream(src + at, stop - at, lit, *huf, lits);
  } else {
    if (stop - at < 10) throw Refused();
    int64_t s[4];
    s[0] = int64_t(load_le(src, end, at, 2));
    s[1] = int64_t(load_le(src, end, at + 2, 2));
    s[2] = int64_t(load_le(src, end, at + 4, 2));
    s[3] = (stop - at) - 6 - s[0] - s[1] - s[2];
    if (s[3] < 0) throw Refused();
    int64_t seg = (lit + 3) / 4;
    if (huf->log <= 11 && s[0] >= 8 && s[1] >= 8 && s[2] >= 8 && s[3] >= 8 &&
        3 * seg < lit) {
      huf_fast(src + at, stop - at, s, lit, *huf, lits);
      if (kind != 3) {
        f.huf = built;
        f.has_huf = true;
      }
      return head + csize;
    }
    at += 6;
    for (int k = 0; k < 4; ++k) {
      huf_stream(src + at, s[k], k < 3 ? seg : lit - 3 * seg, *huf, lits);
      at += s[k];
    }
  }
  if (kind != 3) {
    f.huf = built;
    f.has_huf = true;
  }
  return head + csize;
}

// ZSTD_buildSeqTable for code k (0 literal length, 1 offset, 2 match
// length); returns bytes read.
int64_t seq_table(Frame& f, int k, int mode, const uint8_t* src, int64_t pos,
                  int64_t end) {
  static const int kLargest[3] = {35, 31, 52}, kMaxLog[3] = {9, 8, 9};
  static const int kDefaultLog[3] = {6, 5, 6};
  static const int kDefaultN[3] = {36, 29, 53};
  const int16_t* defaults[3] = {kLLDefault, kOFDefault, kMLDefault};
  std::vector<FseCell> cells;
  int64_t used = 0;
  if (mode == 0) {
    cells = fse_table(defaults[k], kDefaultN[k], kDefaultLog[k]);
  } else if (mode == 1) {
    if (pos >= end) throw Refused();
    if (src[pos] > kLargest[k]) throw Refused();
    cells.push_back({src[pos], 0, 0});
    used = 1;
  } else if (mode == 3) {
    if (!f.has_table[k]) throw Refused();
    return 0;
  } else {
    std::vector<int16_t> counts;
    int log = 0;
    used = read_ncount(src, pos, end, kLargest[k], counts, log);
    if (log > kMaxLog[k]) throw Refused();
    cells = fse_table(counts.data(), int(counts.size()), log);
  }
  std::vector<SeqCell>& t = f.tables[k];
  t.clear();
  for (const FseCell& c : cells) {
    int32_t base, bits;
    if (k == 0) {
      base = kLLBase[c.symbol], bits = kLLBits[c.symbol];
    } else if (k == 2) {
      base = kMLBase[c.symbol], bits = kMLBits[c.symbol];
    } else {
      base = int32_t(uint32_t(1) << c.symbol), bits = c.symbol;
    }
    t.push_back({base, bits, c.nb, c.base});
  }
  f.has_table[k] = true;
  return used;
}

// ZSTD_decodeSeqHeaders and ZSTD_decompressSequences: appends the block's
// output to f.out, or leaves f.out as it was and throws.
void sequences(Frame& f, const std::vector<uint8_t>& lits, const uint8_t* src,
               int64_t pos, int64_t end) {
  if (end - pos < 1) throw Refused();
  int64_t n = src[pos++];
  if (n > 0x7F) {
    if (n == 0xFF) {
      if (pos + 2 > end) throw Refused();
      n = src[pos] + (int64_t(src[pos + 1]) << 8) + 0x7F00;
      pos += 2;
    } else {
      if (pos >= end) throw Refused();
      n = ((n - 0x80) << 8) + src[pos];
      pos += 1;
    }
  }
  if (n == 0) {
    if (pos != end) throw Refused();
    f.out.insert(f.out.end(), lits.begin(), lits.end());
    return;
  }
  if (pos + 1 > end) throw Refused();
  int modes = src[pos++];
  if (modes & 3) throw Refused();
  pos += seq_table(f, 0, modes >> 6, src, pos, end);
  pos += seq_table(f, 1, (modes >> 4) & 3, src, pos, end);
  pos += seq_table(f, 2, (modes >> 2) & 3, src, pos, end);
  Back bs(src + pos, end - pos);
  const std::vector<SeqCell>& llt = f.tables[0];
  const std::vector<SeqCell>& oft = f.tables[1];
  const std::vector<SeqCell>& mlt = f.tables[2];
  int64_t sl = int64_t(bs.read(bit_length(llt.size()) - 1));
  int64_t so = int64_t(bs.read(bit_length(oft.size()) - 1));
  int64_t sm = int64_t(bs.read(bit_length(mlt.size()) - 1));
  std::vector<uint8_t>& out = f.out;
  size_t start = out.size();
  int64_t* rep = f.rep;
  size_t lp = 0;
  try {
    for (int64_t k = 0; k < n; ++k) {
      SeqCell l = llt[size_t(sl)], o = oft[size_t(so)], m = mlt[size_t(sm)];
      int64_t value = o.base + int64_t(bs.read(o.bits));
      int64_t ml = m.base + int64_t(bs.read(m.bits));
      int64_t ll = l.base + int64_t(bs.read(l.bits));
      int64_t offset;
      if (o.bits > 1) {
        offset = value - 3;
        rep[2] = rep[1], rep[1] = rep[0], rep[0] = offset;
      } else if (o.bits == 0) {
        int ll0 = l.base == 0;
        offset = rep[ll0];
        rep[1] = rep[1 - ll0];
        rep[0] = offset;
      } else {
        int64_t idx = value - 1 + (l.base == 0);
        int64_t temp = idx == 3 ? rep[0] - 1 : rep[idx];
        if (temp == 0) temp = -1;
        if (idx != 1) rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset = temp;
      }
      if (k != n - 1) {
        sl = l.next + int64_t(bs.read(l.nb));
        sm = m.next + int64_t(bs.read(m.nb));
        so = o.next + int64_t(bs.read(o.nb));
      }
      if (int64_t(lp) + ll > int64_t(lits.size())) throw Refused();
      out.insert(out.end(), lits.begin() + int64_t(lp),
                 lits.begin() + int64_t(lp) + ll);
      lp += size_t(ll);
      if (offset <= 0 || offset > int64_t(out.size())) throw Refused();
      size_t at = out.size() - size_t(offset);
      for (int64_t i = 0; i < ml; ++i) {
        const uint8_t b = out[at + size_t(i)];  // may be a byte just copied
        out.push_back(b);
      }
    }
    if (bs.left != 0) throw Refused();
  } catch (...) {
    out.resize(start);
    throw;
  }
  out.insert(out.end(), lits.begin() + int64_t(lp), lits.end());
}

struct Header {
  int64_t size, fcs, window, dict_id;  // fcs -1: unknown
  bool check;
};

Header frame_header(const uint8_t* src, int64_t n, int64_t pos) {
  if (n - pos < 5) throw Short();
  int fhd = src[pos + 4];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1;
  static const int kDict[4] = {0, 1, 2, 4};
  int dict_size = kDict[fhd & 3];
  int fcs_size = fcs_flag == 0 ? single : fcs_flag == 1 ? 2 : fcs_flag == 2 ? 4 : 8;
  Header h;
  h.size = 5 + !single + dict_size + fcs_size;
  if (n - pos < h.size) throw Short();
  if (fhd & 8) throw Refused();
  int64_t at = pos + 5;
  h.window = 0;
  if (!single) {
    int wd = src[at++];
    int wlog = 10 + (wd >> 3);
    if (wlog > 31) throw Refused();
    h.window = (int64_t(1) << wlog) + ((int64_t(1) << wlog) >> 3) * (wd & 7);
  }
  h.dict_id = int64_t(load_le(src, n, at, dict_size));
  at += dict_size;
  h.fcs = -1;
  if (fcs_size) {
    uint64_t v = load_le(src, n, at, fcs_size);
    if (fcs_size == 2) v += 256;
    // a content size past 2^62 is never reached: an output that long is
    // refused before it ends
    h.fcs = v > (uint64_t(1) << 62) ? (int64_t(1) << 62) : int64_t(v);
  }
  if (single) h.window = h.fcs;
  h.check = fhd & 4;
  return h;
}

struct Block {
  int kind, last;
  int64_t size, at;
};

// The block header at pos, checked as ZSTD_getcBlockSize checks it; a
// stream decoder (block_max >= 0) also refuses a block past block_max and
// takes the part of a raw block that the data holds (partial set).
Block block_header(const uint8_t* src, int64_t n, int64_t pos,
                   int64_t block_max, bool& partial) {
  partial = false;
  if (n - pos < 3) throw Short();
  uint32_t h = uint32_t(load_le(src, n, pos, 3));
  Block b = {int((h >> 1) & 3), int(h & 1), int64_t(h >> 3), pos + 3};
  if (b.kind == 3) throw Refused();
  int64_t csize = b.kind == 1 ? 1 : b.size;
  if (block_max >= 0 && csize > block_max) throw Refused();
  if (csize > n - pos - 3) {
    if (block_max >= 0 && b.kind == 0) {
      partial = true;
      b.size = n - pos - 3;
      b.last = 0;
      return b;
    }
    throw Short();
  }
  return b;
}

// ZSTD_findFrameCompressedSize: the frame's bytes, or -1.
int64_t frame_size(const uint8_t* src, int64_t n, int64_t pos) {
  try {
    Header h = frame_header(src, n, pos);
    int64_t p = pos + h.size, end = p;
    for (;;) {
      bool partial;
      Block b = block_header(src, n, p, -1, partial);
      end = b.at + (b.kind == 1 ? 1 : b.size);
      p = end;
      if (b.last) break;
    }
    end += 4 * h.check;
    return end <= n ? end - pos : -1;
  } catch (Refused&) {
    return -1;
  } catch (Short&) {
    return -1;
  }
}

// One frame from pos into out; returns the position after it. With
// limit >= 0, stops after the first block whose output passes it, or
// (Short caught) where the data ends.
int64_t decode_frame(const uint8_t* src, int64_t n, int64_t pos, int64_t limit,
                     std::vector<uint8_t>& result) {
  if (limit < 0 && n - pos < 9) throw Refused();
  Header h = frame_header(src, n, pos);
  if (limit < 0 && n - pos < h.size + 3) throw Refused();
  if (limit >= 0) {
    if (h.fcs >= 0 && h.fcs <= limit && frame_size(src, n, pos) > 0)
      return decode_frame(src, n, pos, -1, result);
    if (h.window > kStreamWindowMax) throw Refused();
  }
  if (h.dict_id) throw Refused();
  Frame f;
  f.block_max = h.window < kBlockSizeMax ? h.window : kBlockSizeMax;
  // The stream decoder's buffer: a window and two blocks, or the content
  // size where that is less (then a block past it does not fit).
  int64_t cap = -1;
  if (limit >= 0 && h.fcs >= 0 &&
      h.fcs <= (h.window > 1024 ? h.window : 1024) + 2 * f.block_max + 64)
    cap = h.fcs;
  std::vector<uint8_t> lits;
  try {
    pos += h.size;
    for (;;) {
      bool partial;
      Block b = block_header(src, n, pos, limit >= 0 ? f.block_max : -1,
                             partial);
      int64_t before = int64_t(f.out.size());
      bool empty = limit >= 0 && b.kind != 1 && b.size == 0;
      if (b.kind == 0 || empty) {
        f.out.insert(f.out.end(), src + b.at, src + b.at + b.size);
        pos = b.at + b.size;
      } else if (b.kind == 1) {
        f.out.insert(f.out.end(), size_t(b.size), src[b.at]);
        pos = b.at + 1;
      } else {
        if (b.size > f.block_max) throw Refused();
        int64_t used = literals(f, src, b.at, b.at + b.size, lits);
        sequences(f, lits, src, b.at + used, b.at + b.size);
        pos = b.at + b.size;
      }
      int64_t got = int64_t(f.out.size());
      if (limit >= 0 && got - before > f.block_max) throw Refused();
      if (cap >= 0 && got > cap) throw Refused();
      if (partial) throw Short();
      if (b.last && h.fcs >= 0 && !empty && got != h.fcs) throw Refused();
      if (limit >= 0 && got > limit) break;
      if (b.last) {
        if (limit < 0 && h.fcs >= 0 && got != h.fcs) throw Refused();
        if (h.check) {
          if (n - pos < 4) throw Short();
          uint32_t want = uint32_t(load_le(src, n, pos, 4));
          if (want != uint32_t(xxh64(f.out.data(), got))) throw Refused();
          pos += 4;
        }
        break;
      }
    }
  } catch (Short&) {
    if (limit < 0) throw Refused();
    pos = n;
  }
  result.insert(result.end(), f.out.begin(), f.out.end());
  return pos;
}

}  // namespace

extern "C" int64_t wpt_zstd(const char* data, int64_t n, int64_t limit,
                            uint8_t* out, int64_t cap, int64_t* out_len) {
  const uint8_t* src = reinterpret_cast<const uint8_t*>(data);
  std::vector<uint8_t> result;
  try {
    if (limit >= 0) {
      if (n < 4) {
        *out_len = 0;
        return 0;
      }
      uint32_t magic = uint32_t(load_le(src, n, 0, 4));
      if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
        *out_len = 0;
        return 0;
      }
      if (magic != kMagic) return 1;
      try {
        decode_frame(src, n, 0, limit, result);
      } catch (Short&) {
        result.clear();
      }
      if (int64_t(result.size()) > limit) result.resize(size_t(limit));
    } else {
      int64_t pos = 0;
      while (n - pos >= 5) {
        uint32_t magic = uint32_t(load_le(src, n, pos, 4));
        if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
          if (n - pos < 8) return 1;
          int64_t size = int64_t(load_le(src, n, pos + 4, 4));
          if (size + 8 > n - pos) return 1;
          pos += 8 + size;
          continue;
        }
        if (magic != kMagic) return 1;
        pos = decode_frame(src, n, pos, -1, result);
      }
      if (pos != n) return 1;
    }
  } catch (Refused&) {
    return 1;
  } catch (Short&) {
    return 1;
  }
  *out_len = int64_t(result.size());
  if (*out_len > cap) return 2;
  if (*out_len) std::memcpy(out, result.data(), result.size());
  return 0;
}
