// The sequential loops of the WebP reader, the same numbers as the plain
// versions in utils/webp.py:
// * wpt_vp8l: a VP8L image stream (prefix codes, the meta prefix-code
//   image, LZ77 backward references, the colour cache, and the predictor,
//   cross-colour, subtract-green and colour-indexing transforms undone),
//   vp8l_plain;
// * wpt_vp8: a VP8 key frame as libwebp reconstructs it (frame header,
//   coefficient tokens, intra prediction, inverse transforms, loop
//   filter), vp8_plain;
// * wpt_yuv_to_rgb: libwebp's fancy chroma upsampling and fixed-point
//   YUV->RGB, yuv_to_rgb_plain;
// * wpt_alpha_unfilter: the ALPH unfilters, unfilter_plain.
// Status codes: 0 done, 1 bad VP8L bitstream, 2 VP8L data ends early,
// 3 VP8 data ends early, 4 bad VP8 frame header.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// --- VP8L -------------------------------------------------------------------

struct LBits {
  const uint8_t* data;
  int64_t n;
  int64_t pos;
  int64_t limit;
  uint32_t peek32(int64_t p) const {
    const int64_t at = p >> 3;
    uint64_t v = 0;
    for (int i = 0; i < 5; ++i)
      if (at + i < n) v |= static_cast<uint64_t>(data[at + i]) << (8 * i);
    return static_cast<uint32_t>(v >> (p & 7));
  }
  uint32_t read(int nb) {
    if (nb == 0) return 0;
    const uint32_t v = peek32(pos);
    pos += nb;
    return v & ((1u << nb) - 1);
  }
  bool over() const { return pos > limit; }
};

constexpr int kRootBits = 10;

// A prefix code: one symbol (bits 0), or a root table of kRootBits bits
// (symbol << 4 | length; length 0 for longer codes, decoded canonically).
struct Code {
  int single = 0;
  int bits = 0;
  std::vector<uint32_t> root;
  int first[17] = {0}, count[17] = {0}, index[17] = {0};
  std::vector<uint16_t> sorted;
};

bool build_code(const std::vector<int>& lengths, Code* code) {
  int count[16] = {0};
  for (int n : lengths) {
    if (n > 15) return false;
    ++count[n];
  }
  const int used = static_cast<int>(lengths.size()) - count[0];
  if (used == 0) return false;
  if (used == 1) {
    for (size_t s = 0; s < lengths.size(); ++s)
      if (lengths[s]) code->single = static_cast<int>(s);
    code->bits = 0;
    return true;
  }
  int64_t kraft = 0;
  for (int n = 1; n < 16; ++n) kraft += static_cast<int64_t>(count[n]) << (15 - n);
  if (kraft != (1 << 15)) return false;
  int maxlen = 0;
  for (int n = 1; n < 16; ++n)
    if (count[n]) maxlen = n;
  code->bits = std::min(maxlen, kRootBits);
  code->root.assign(static_cast<size_t>(1) << code->bits, 0);
  int c = 0, idx = 0;
  for (int n = 1; n < 16; ++n) {
    code->first[n] = c;
    code->count[n] = count[n];
    code->index[n] = idx;
    for (size_t s = 0; s < lengths.size(); ++s) {
      if (lengths[s] != n) continue;
      code->sorted.push_back(static_cast<uint16_t>(s));
      if (n <= code->bits) {
        int r = 0;
        for (int i = 0; i < n; ++i) r |= ((c >> i) & 1) << (n - 1 - i);
        for (int k = r; k < (1 << code->bits); k += 1 << n)
          code->root[k] = (static_cast<uint32_t>(s) << 4) | n;
      }
      ++c;
      ++idx;
    }
    c <<= 1;
  }
  return true;
}

inline int read_sym(LBits& br, const Code& code) {
  if (code.bits == 0) return code.single;
  const uint32_t v = br.peek32(br.pos);
  const uint32_t e = code.root[v & ((1u << code.bits) - 1)];
  if (e & 15) {
    br.pos += e & 15;
    return static_cast<int>(e >> 4);
  }
  int c = 0;
  for (int n = 1; n < 16; ++n) {
    c = (c << 1) | ((v >> (n - 1)) & 1);
    if (c - code.first[n] < code.count[n] && c >= code.first[n]) {
      br.pos += n;
      return code.sorted[code.index[n] + c - code.first[n]];
    }
  }
  return 0;  // a complete code always ends above
}

const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2,  3,  4,  5,  16, 6,
                                  7,  8,  9, 10, 11, 12, 13, 14, 15};

struct Fail {
  int status;
};

void read_code(LBits& br, int alphabet, Code* code) {
  std::vector<int> lengths(std::max(alphabet, 256), 0);
  if (br.read(1)) {
    const int two = br.read(1);
    const int first_bits = br.read(1) ? 8 : 1;
    lengths[br.read(first_bits)] = 1;
    if (two) lengths[br.read(8)] = 1;
    lengths.resize(alphabet);
  } else {
    std::vector<int> cl(19, 0);
    const int num = br.read(4) + 4;
    for (int i = 0; i < num; ++i) cl[kCodeLengthOrder[i]] = br.read(3);
    Code lcode;
    if (!build_code(cl, &lcode)) throw Fail{1};
    int max_symbol = alphabet;
    if (br.read(1)) {
      const int nb = 2 + 2 * br.read(3);
      max_symbol = 2 + br.read(nb);
      if (max_symbol > alphabet) throw Fail{1};
    }
    lengths.assign(alphabet, 0);
    int s = 0, prev = 8;
    while (s < alphabet) {
      if (max_symbol == 0) break;
      --max_symbol;
      const int c = read_sym(br, lcode);
      if (c < 16) {
        lengths[s++] = c;
        if (c) prev = c;
      } else {
        static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
        const int rep = br.read(extra[c - 16]) + offset[c - 16];
        if (s + rep > alphabet) throw Fail{1};
        for (int i = 0; i < rep; ++i) lengths[s++] = c == 16 ? prev : 0;
      }
    }
  }
  if (br.over()) throw Fail{2};
  if (!build_code(lengths, code)) throw Fail{1};
}

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

inline int copy_value(int symbol, LBits& br) {
  if (symbol < 4) return symbol + 1;
  const int extra = (symbol - 2) >> 1;
  return ((2 + (symbol & 1)) << extra) + static_cast<int>(br.read(extra)) + 1;
}

struct Transform {
  int kind, xsize, bits;
  std::vector<uint32_t> data;
};

struct VP8LCtx {
  LBits br;
  const uint8_t* code_to_plane;
  bool alpha;  // the stream of an ALPH chunk
};

std::vector<uint32_t> decode_stream(VP8LCtx& ctx, int xsize, int ysize, bool level0,
                                    std::vector<Transform>* transforms);

// libwebp's VP8LBitReader as it reads past its data (utils/webp.py's
// _TailBits): a 64-bit window of the last bytes from bit `base`, reads at 64
// bits or more into it wrap, and a byte shift that finds the stream over sets
// eos and goes back to the window's start; ReadBits then gives 0.
struct TailBits {
  LBits b;
  int64_t base;
  bool eos = false;
  int64_t at(int ahead = 0) const {
    const int64_t p = b.pos + ahead - base;
    return p < 64 ? b.pos + ahead : base + (p & 63);
  }
  void shift() {
    if (b.pos > b.limit) {
      eos = true;
      b.pos = base;
    }
  }
  uint32_t read(int nb) {
    if (eos) {
      b.pos = base;
      return 0;
    }
    const uint32_t v = b.peek32(at());
    b.pos += nb;
    shift();
    return v & ((1u << nb) - 1);
  }
  // ReadSymbol's two table levels, each prefetched (and wrapped) on its own.
  int sym(const Code& code) {
    if (code.bits == 0) return code.single;
    const uint32_t v = (b.peek32(at()) & 0xFF) | (b.peek32(at(8)) << 8);
    const uint8_t bytes[4] = {uint8_t(v), uint8_t(v >> 8), uint8_t(v >> 16),
                              uint8_t(v >> 24)};
    LBits r{bytes, 4, 0, 32};
    const int s = read_sym(r, code);
    b.pos += r.pos;
    return s;
  }
};

inline int tail_copy_value(int symbol, TailBits& tb) {
  if (symbol < 4) return symbol + 1;
  const int extra = (symbol - 2) >> 1;
  return ((2 + (symbol & 1)) << extra) + static_cast<int>(tb.read(extra)) + 1;
}

// DecodeAlphaData, libwebp's 8-bit path for an ALPH stream: green symbols and
// backward references through TailBits, the end of the stream checked after
// each symbol, an error only where pixels are left.
void decode_alpha8(VP8LCtx& ctx, int xsize, int ysize, const std::vector<Code>& codes,
                   int hbits, const std::vector<int>& himage, int hxsize,
                   std::vector<uint32_t>& out) {
  const int64_t total = static_cast<int64_t>(xsize) * ysize;
  out.assign(total, 0);
  TailBits tb{ctx.br, ctx.br.limit - 64};
  int64_t pos = 0;
  int x = 0, y = 0;
  const Code* g = codes.data();
  while (pos < total && !tb.eos) {
    tb.shift();
    if (!himage.empty())
      g = codes.data() + 5 * himage[static_cast<int64_t>(y >> hbits) * hxsize + (x >> hbits)];
    const int code = tb.sym(g[0]);
    if (code < 256) {
      out[pos++] = (static_cast<uint32_t>(g[3].single) << 24) |
                   (static_cast<uint32_t>(g[1].single) << 16) |
                   (static_cast<uint32_t>(code) << 8) | static_cast<uint32_t>(g[2].single);
      ++x;
    } else if (code < 280) {
      const int length = tail_copy_value(code - 256, tb);
      const int dsym = tb.sym(g[4]);
      tb.shift();
      const int dcode = tail_copy_value(dsym, tb);
      int64_t dist;
      if (dcode > 120) {
        dist = dcode - 120;
      } else {
        const int v = ctx.code_to_plane[dcode - 1];
        dist = static_cast<int64_t>(v >> 4) * xsize + 8 - (v & 15);
        if (dist < 1) dist = 1;
      }
      if (dist > pos || total - pos < length) throw Fail{1};
      for (int64_t i = pos; i < pos + length; ++i) out[i] = out[i - dist];
      pos += length;
      x += length;
    } else {
      throw Fail{1};
    }
    while (x >= xsize) {
      x -= xsize;
      ++y;
    }
    tb.eos = tb.eos || tb.b.over();
  }
  if (tb.eos && pos < total) throw Fail{2};
  ctx.br.pos = tb.b.pos;
}

void decode_pixels(VP8LCtx& ctx, int xsize, int ysize, const std::vector<Code>& codes,
                   int hbits, const std::vector<int>& himage, int hxsize, int cache_bits,
                   std::vector<uint32_t>& out) {
  LBits& br = ctx.br;
  const int64_t total = static_cast<int64_t>(xsize) * ysize;
  out.assign(total, 0);
  std::vector<uint32_t> cache(cache_bits ? (1u << cache_bits) : 0);
  const int shift = 32 - cache_bits;
  int64_t cached = 0, pos = 0;
  int x = 0, y = 0;
  const Code* g = codes.data();
  while (pos < total) {
    if (!himage.empty())
      g = codes.data() + 5 * himage[static_cast<int64_t>(y >> hbits) * hxsize + (x >> hbits)];
    const int code = read_sym(br, g[0]);
    if (code < 256) {
      const uint32_t red = read_sym(br, g[1]);
      const uint32_t blue = read_sym(br, g[2]);
      const uint32_t alpha = read_sym(br, g[3]);
      out[pos++] = (alpha << 24) | (red << 16) | (static_cast<uint32_t>(code) << 8) | blue;
      ++x;
    } else if (code < 280) {
      const int length = copy_value(code - 256, br);
      const int dcode = copy_value(read_sym(br, g[4]), br);
      int64_t dist;
      if (dcode > 120) {
        dist = dcode - 120;
      } else {
        const int v = ctx.code_to_plane[dcode - 1];
        dist = static_cast<int64_t>(v >> 4) * xsize + 8 - (v & 15);
        if (dist < 1) dist = 1;
      }
      if (br.over()) throw Fail{2};
      if (dist > pos || total - pos < length) throw Fail{1};
      for (int64_t i = pos; i < pos + length; ++i) out[i] = out[i - dist];
      pos += length;
      x += length;
    } else {
      while (cached < pos) {
        const uint32_t v = out[cached++];
        cache[(v * 0x1E35A7BDu) >> shift] = v;
      }
      out[pos++] = cache[code - 280];
      ++x;
    }
    while (x >= xsize) {
      x -= xsize;
      ++y;
    }
  }
}

std::vector<uint32_t> decode_stream(VP8LCtx& ctx, int xsize, int ysize, bool level0,
                                    std::vector<Transform>* transforms) {
  LBits& br = ctx.br;
  int seen = 0;
  if (level0) {
    while (br.read(1)) {
      const int kind = br.read(2);
      if (seen & (1 << kind)) throw Fail{1};
      seen |= 1 << kind;
      Transform t{kind, xsize, 0, {}};
      if (kind == 0 || kind == 1) {
        t.bits = br.read(3) + 2;
        t.data = decode_stream(ctx, subsample(xsize, t.bits), subsample(ysize, t.bits), false,
                               nullptr);
      } else if (kind == 3) {
        const int n = br.read(8) + 1;
        t.bits = n > 16 ? 0 : n > 4 ? 1 : n > 2 ? 2 : 3;
        std::vector<uint32_t> pal = decode_stream(ctx, n, 1, false, nullptr);
        t.data.assign(1u << (8 >> t.bits), 0);
        uint8_t* dst = reinterpret_cast<uint8_t*>(t.data.data());
        const uint8_t* src = reinterpret_cast<const uint8_t*>(pal.data());
        for (int i = 0; i < 4 * n; ++i)
          dst[i] = static_cast<uint8_t>(src[i] + (i >= 4 ? dst[i - 4] : 0));
        xsize = subsample(xsize, t.bits);
      }
      transforms->push_back(std::move(t));
    }
  }
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = br.read(4);
    if (cache_bits < 1 || cache_bits > 11) throw Fail{1};
  }
  int hbits = 0, hxsize = 0, groups = 1;
  std::vector<int> himage;
  if (level0 && br.read(1)) {
    hbits = br.read(3) + 2;
    hxsize = subsample(xsize, hbits);
    std::vector<uint32_t> data =
        decode_stream(ctx, hxsize, subsample(ysize, hbits), false, nullptr);
    himage.resize(data.size());
    for (size_t i = 0; i < data.size(); ++i) {
      himage[i] = (data[i] >> 8) & 0xFFFF;
      groups = std::max(groups, himage[i] + 1);
    }
  }
  const int alphabets[5] = {256 + 24 + (cache_bits ? 1 << cache_bits : 0), 256, 256, 256, 40};
  std::vector<Code> codes(5 * static_cast<size_t>(groups));
  for (int g = 0; g < groups; ++g)
    for (int j = 0; j < 5; ++j) read_code(br, alphabets[j], &codes[5 * g + j]);
  // An alpha stream of one colour-indexing transform, no cache and one-symbol
  // red, blue and alpha codes takes libwebp's 8-bit path.
  bool eight = ctx.alpha && level0 && transforms->size() == 1 &&
               (*transforms)[0].kind == 3 && cache_bits == 0;
  for (int g = 0; eight && g < groups; ++g)
    eight = codes[5 * g + 1].bits == 0 && codes[5 * g + 2].bits == 0 &&
            codes[5 * g + 3].bits == 0;
  std::vector<uint32_t> out;
  if (eight) {
    decode_alpha8(ctx, xsize, ysize, codes, hbits, himage, hxsize, out);
    return out;
  }
  decode_pixels(ctx, xsize, ysize, codes, hbits, himage, hxsize, cache_bits, out);
  if (br.over()) throw Fail{2};
  return out;
}

inline uint32_t add_argb(uint32_t a, uint32_t b) {
  return (((a & 0xFF00FF00u) + (b & 0xFF00FF00u)) & 0xFF00FF00u) |
         (((a & 0x00FF00FFu) + (b & 0x00FF00FFu)) & 0x00FF00FFu);
}

inline uint32_t avg2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xFEFEFEFEu) >> 1) + (a & b); }

inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

uint32_t predict(int mode, uint32_t left, uint32_t top, uint32_t tl, uint32_t tr) {
  switch (mode) {
    case 1: return left;
    case 2: return top;
    case 3: return tr;
    case 4: return tl;
    case 5: return avg2(avg2(left, tr), top);
    case 6: return avg2(left, tl);
    case 7: return avg2(left, top);
    case 8: return avg2(tl, top);
    case 9: return avg2(top, tr);
    case 10: return avg2(avg2(left, tl), avg2(top, tr));
    case 11: {
      int pa_minus_pb = 0;
      for (int s = 24; s >= 0; s -= 8) {
        const int a = (top >> s) & 0xFF, b = (left >> s) & 0xFF, c = (tl >> s) & 0xFF;
        pa_minus_pb += std::abs(b - c) - std::abs(a - c);
      }
      return pa_minus_pb <= 0 ? top : left;
    }
    case 12: {
      uint32_t v = 0;
      for (int s = 24; s >= 0; s -= 8)
        v |= static_cast<uint32_t>(clip255(static_cast<int>((left >> s) & 0xFF) +
                                           static_cast<int>((top >> s) & 0xFF) -
                                           static_cast<int>((tl >> s) & 0xFF)))
             << s;
      return v;
    }
    case 13: {
      const uint32_t avg = avg2(left, top);
      uint32_t v = 0;
      for (int s = 24; s >= 0; s -= 8) {
        const int a = (avg >> s) & 0xFF, b = (tl >> s) & 0xFF;
        v |= static_cast<uint32_t>(clip255(a + (a - b) / 2)) << s;
      }
      return v;
    }
    default: return 0xFF000000u;
  }
}

std::vector<uint32_t> inverse_transforms(std::vector<uint32_t> cur,
                                         const std::vector<Transform>& ts, int height) {
  for (auto it = ts.rbegin(); it != ts.rend(); ++it) {
    const Transform& t = *it;
    const int w = t.xsize;
    if (t.kind == 0) {
      std::vector<uint32_t> out(cur.size());
      const int tiles = subsample(w, t.bits);
      for (int y = 0; y < height; ++y) {
        const int64_t row = static_cast<int64_t>(y) * w;
        for (int x = 0; x < w; ++x) {
          const int64_t i = row + x;
          uint32_t pred;
          if (y == 0) {
            pred = x == 0 ? 0xFF000000u : out[i - 1];
          } else if (x == 0) {
            pred = out[i - w];
          } else {
            const int mode =
                (t.data[static_cast<int64_t>(y >> t.bits) * tiles + (x >> t.bits)] >> 8) & 15;
            pred = predict(mode, out[i - 1], out[i - w], out[i - w - 1], out[i - w + 1]);
          }
          out[i] = add_argb(cur[i], pred);
        }
      }
      cur.swap(out);
    } else if (t.kind == 2) {
      for (uint32_t& p : cur) {
        const uint32_t g = (p >> 8) & 0xFF;
        p = (p & 0xFF00FF00u) | ((((p >> 16) + g) & 0xFF) << 16) | ((p + g) & 0xFF);
      }
    } else if (t.kind == 1) {
      const int tiles = subsample(w, t.bits);
      for (int y = 0; y < height; ++y) {
        for (int x = 0; x < w; ++x) {
          const uint32_t m = t.data[static_cast<int64_t>(y >> t.bits) * tiles + (x >> t.bits)];
          uint32_t& p = cur[static_cast<int64_t>(y) * w + x];
          const int g2r = static_cast<int8_t>(m & 0xFF);
          const int g2b = static_cast<int8_t>((m >> 8) & 0xFF);
          const int r2b = static_cast<int8_t>((m >> 16) & 0xFF);
          const int green = static_cast<int8_t>((p >> 8) & 0xFF);
          int red = (p >> 16) & 0xFF;
          red = (red + ((g2r * green) >> 5)) & 0xFF;
          int blue = p & 0xFF;
          blue += (g2b * green) >> 5;
          blue += (r2b * static_cast<int8_t>(red)) >> 5;
          blue &= 0xFF;
          p = (p & 0xFF00FF00u) | (static_cast<uint32_t>(red) << 16) | static_cast<uint32_t>(blue);
        }
      }
    } else {
      const int packed = subsample(w, t.bits);
      std::vector<uint32_t> out(static_cast<size_t>(w) * height);
      const int bpp = 8 >> t.bits, per = 1 << t.bits, mask = (1 << bpp) - 1;
      for (int y = 0; y < height; ++y) {
        for (int x = 0; x < w; ++x) {
          const uint32_t v = (cur[static_cast<int64_t>(y) * packed + (x >> t.bits)] >> 8) & 0xFF;
          const uint32_t idx = t.bits ? (v >> (bpp * (x & (per - 1)))) & mask : v;
          out[static_cast<int64_t>(y) * w + x] = t.data[idx];
        }
      }
      cur.swap(out);
    }
  }
  return cur;
}

// --- VP8 --------------------------------------------------------------------

struct BoolDec {
  const uint8_t* data;
  int64_t pos, end;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 254;
  bool eof = false;
  BoolDec() : data(nullptr), pos(0), end(0) {}
  BoolDec(const uint8_t* d, int64_t s, int64_t e) : data(d), pos(s), end(e) {}
  int bit(int prob) {
    uint32_t rng = range;
    if (bits < 0) {
      if (pos < end) {
        value = (value << 8) | data[pos++];
        bits += 8;
      } else if (!eof) {
        value <<= 8;
        bits += 8;
        eof = true;
      } else {
        bits = 0;
      }
    }
    const uint32_t split = (rng * static_cast<uint32_t>(prob)) >> 8;
    int b;
    if ((value >> bits) > split) {
      rng -= split;
      value -= static_cast<uint64_t>(split + 1) << bits;
      b = 1;
    } else {
      rng = split + 1;
      b = 0;
    }
    const int shift = 7 ^ (31 - __builtin_clz(rng));
    range = (rng << shift) - 1;
    bits -= shift;
    return b;
  }
  int value_bits(int n) {
    int v = 0;
    while (n-- > 0) v |= bit(0x80) << n;
    return v;
  }
  int signed_value(int n) {
    const int v = value_bits(n);
    return bit(0x80) ? -v : v;
  }
};

const int kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const int kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

inline int16_t w16(int v) { return static_cast<int16_t>(static_cast<uint16_t>(v)); }
inline int clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }
inline int mulhi(int a, int k) { return (a * k) >> 16; }

typedef uint8_t Probas[4][8][3][11];

int get_coeffs(BoolDec& br, const Probas& probs, int typ, int ctx, const int dq[2], int n,
               int16_t* out) {
  const uint8_t* p = probs[typ][kBands[n]][ctx];
  while (n < 16) {
    if (!br.bit(p[0])) return n;
    while (!br.bit(p[1])) {
      ++n;
      p = probs[typ][kBands[n]][0];
      if (n == 16) return 16;
    }
    const uint8_t(*nxt)[11] = probs[typ][kBands[n + 1]];
    int v;
    if (!br.bit(p[2])) {
      v = 1;
      p = nxt[1];
    } else {
      if (!br.bit(p[3])) {
        v = !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
      } else if (!br.bit(p[6])) {
        if (!br.bit(p[7])) {
          v = 5 + br.bit(159);
        } else {
          v = 7 + 2 * br.bit(165);
          v += br.bit(145);
        }
      } else {
        const int bit1 = br.bit(p[8]);
        const int bit0 = br.bit(p[9 + bit1]);
        const int cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
        v += 3 + (8 << cat);
      }
      p = nxt[2];
    }
    const int sign = br.bit(0x80);
    out[kZigzag[n]] = w16((sign ? -v : v) * dq[n > 0]);
    ++n;
  }
  return 16;
}

void idct_full(const int16_t* c, uint8_t* dst, int s) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int i0 = c[i], i1 = c[4 + i], i2 = c[8 + i], i3 = c[12 + i];
    const int a = w16(i0 + i2), b = w16(i0 - i2);
    const int cc = w16(w16(i1 - i3) + w16(mulhi(i1, -30068) - mulhi(i3, 20091)));
    const int d = w16(w16(i1 + i3) + w16(mulhi(i1, 20091) + mulhi(i3, -30068)));
    tmp[4 * i] = w16(a + d);
    tmp[4 * i + 1] = w16(b + cc);
    tmp[4 * i + 2] = w16(b - cc);
    tmp[4 * i + 3] = w16(a - d);
  }
  for (int i = 0; i < 4; ++i) {
    const int t0 = tmp[i], t1 = tmp[4 + i], t2 = tmp[8 + i], t3 = tmp[12 + i];
    const int dc = w16(t0 + 4);
    const int a = w16(dc + t2), b = w16(dc - t2);
    const int cc = w16(w16(t1 - t3) + w16(mulhi(t1, -30068) - mulhi(t3, 20091)));
    const int d = w16(w16(t1 + t3) + w16(mulhi(t1, 20091) + mulhi(t3, -30068)));
    const int v[4] = {w16(a + d), w16(b + cc), w16(b - cc), w16(a - d)};
    uint8_t* row = dst + i * s;
    for (int x = 0; x < 4; ++x) row[x] = static_cast<uint8_t>(clip8(w16(row[x] + (v[x] >> 3))));
  }
}

void idct_ac3(const int16_t* c, uint8_t* dst, int s) {
  const int a = c[0] + 4;
  const int c4 = mul2(c[4]), d4 = mul1(c[4]);
  const int c1 = mul2(c[1]), d1 = mul1(c[1]);
  const int dcs[4] = {a + d4, a + c4, a - c4, a - d4};
  for (int y = 0; y < 4; ++y) {
    const int dc = dcs[y];
    const int v[4] = {dc + d1, dc + c1, dc - c1, dc - d1};
    uint8_t* row = dst + y * s;
    for (int x = 0; x < 4; ++x) row[x] = static_cast<uint8_t>(clip8(row[x] + (v[x] >> 3)));
  }
}

void idct_dc(const int16_t* c, uint8_t* dst, int s) {
  const int dc = (c[0] + 4) >> 3;
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x) dst[y * s + x] = static_cast<uint8_t>(clip8(dst[y * s + x] + dc));
}

void transform(int code, const int16_t* c, uint8_t* dst, int s) {
  if (code == 3)
    idct_full(c, dst, s);
  else if (code == 2)
    idct_ac3(c, dst, s);
  else if (code == 1)
    idct_dc(c, dst, s);
}

void wht(const int16_t* dc, int16_t out[16]) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = dc[i] + dc[12 + i], a1 = dc[4 + i] + dc[8 + i];
    const int a2 = dc[4 + i] - dc[8 + i], a3 = dc[i] - dc[12 + i];
    tmp[i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int d = tmp[4 * i] + 3;
    const int a0 = d + tmp[4 * i + 3], a1 = tmp[4 * i + 1] + tmp[4 * i + 2];
    const int a2 = tmp[4 * i + 1] - tmp[4 * i + 2], a3 = d - tmp[4 * i + 3];
    out[4 * i] = w16((a0 + a1) >> 3);
    out[4 * i + 1] = w16((a3 + a2) >> 3);
    out[4 * i + 2] = w16((a0 - a1) >> 3);
    out[4 * i + 3] = w16((a3 - a2) >> 3);
  }
}

inline int nz_code(int nz, bool dc) { return nz > 3 ? 3 : nz > 1 ? 2 : dc ? 1 : 0; }
inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2b(int a, int b) { return (a + b + 1) >> 1; }

enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };

void pred4(int mode, uint8_t* w, int s) {
  const int X = w[-s - 1], A = w[-s], B = w[-s + 1], C = w[-s + 2], D = w[-s + 3];
  const int E = w[-s + 4], F = w[-s + 5], G = w[-s + 6], H = w[-s + 7];
  const int I = w[-1], J = w[s - 1], K = w[2 * s - 1], L = w[3 * s - 1];
#define DST(x, y) w[(x) + (y) * s]
  switch (mode) {
    case B_DC: {
      const int dc = (4 + A + B + C + D + I + J + K + L) >> 3;
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) DST(x, y) = dc;
      break;
    }
    case B_TM: {
      const int lefts[4] = {I, J, K, L}, tops[4] = {A, B, C, D};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) DST(x, y) = clip8(tops[x] + lefts[y] - X);
      break;
    }
    case B_VE: {
      const int v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) DST(x, y) = v[x];
      break;
    }
    case B_HE: {
      const int v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) DST(x, y) = v[y];
      break;
    }
    case B_RD:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = avg2b(X, A);
      DST(1, 0) = DST(2, 2) = avg2b(A, B);
      DST(2, 0) = DST(3, 2) = avg2b(B, C);
      DST(3, 0) = avg2b(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_LD: {
      const int v[7] = {avg3(A, B, C), avg3(B, C, D), avg3(C, D, E), avg3(D, E, F),
                        avg3(E, F, G), avg3(F, G, H), avg3(G, H, H)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) DST(x, y) = v[x + y];
      break;
    }
    case B_VL:
      DST(0, 0) = avg2b(A, B);
      DST(1, 0) = DST(0, 2) = avg2b(B, C);
      DST(2, 0) = DST(1, 2) = avg2b(C, D);
      DST(3, 0) = DST(2, 2) = avg2b(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HD:
      DST(0, 0) = DST(2, 1) = avg2b(I, X);
      DST(0, 1) = DST(2, 2) = avg2b(J, I);
      DST(0, 2) = DST(2, 3) = avg2b(K, J);
      DST(0, 3) = avg2b(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    default:  // B_HU
      DST(0, 0) = avg2b(I, J);
      DST(2, 0) = DST(0, 1) = avg2b(J, K);
      DST(2, 1) = DST(0, 2) = avg2b(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
  }
#undef DST
}

void pred_block(int mode, int size, uint8_t* w, int s, int mb_x, int mb_y) {
  if (mode == B_DC) {
    const int shift = size == 16 ? 4 : 3;
    int st = 0, sl = 0;
    for (int i = 0; i < size; ++i) {
      st += w[-s + i];
      sl += w[i * s - 1];
    }
    int dc;
    if (mb_x > 0 && mb_y > 0)
      dc = (st + sl + size) >> (shift + 1);
    else if (mb_y > 0)
      dc = (st + (size >> 1)) >> shift;
    else if (mb_x > 0)
      dc = (sl + (size >> 1)) >> shift;
    else
      dc = 0x80;
    for (int y = 0; y < size; ++y) std::memset(w + y * s, dc, size);
  } else if (mode == B_TM) {
    const int tl = w[-s - 1];
    for (int y = 0; y < size; ++y)
      for (int x = 0; x < size; ++x) w[y * s + x] = clip8(w[-s + x] + w[y * s - 1] - tl);
  } else if (mode == B_VE) {
    for (int y = 0; y < size; ++y) std::memcpy(w + y * s, w - s, size);
  } else {
    for (int y = 0; y < size; ++y) std::memset(w + y * s, w[y * s - 1], size);
  }
}

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

void filter_edge(uint8_t* px, int64_t step, int limit, int ilimit, int hev, int kind) {
  const int p1 = px[-2 * step], p0 = px[-step], q0 = px[0], q1 = px[step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > 2 * limit + 1) return;
  if (kind) {
    const int p3 = px[-4 * step], p2 = px[-3 * step], q2 = px[2 * step], q3 = px[3 * step];
    if (std::abs(p3 - p2) > ilimit || std::abs(p2 - p1) > ilimit ||
        std::abs(p1 - p0) > ilimit || std::abs(q3 - q2) > ilimit ||
        std::abs(q2 - q1) > ilimit || std::abs(q1 - q0) > ilimit)
      return;
    if (!(std::abs(p1 - p0) > hev || std::abs(q1 - q0) > hev)) {
      if (kind == 4) {
        const int a = 3 * (q0 - p0);
        const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
        const int a3 = (a1 + 1) >> 1;
        px[-2 * step] = clip8(p1 + a3);
        px[-step] = clip8(p0 + a2);
        px[0] = clip8(q0 - a1);
        px[step] = clip8(q1 - a3);
      } else {
        const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
        const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
        px[-3 * step] = clip8(p2 + a3);
        px[-2 * step] = clip8(p1 + a2);
        px[-step] = clip8(p0 + a1);
        px[0] = clip8(q0 - a1);
        px[step] = clip8(q1 - a2);
        px[2 * step] = clip8(q2 - a3);
      }
      return;
    }
  }
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  px[-step] = clip8(p0 + a2);
  px[0] = clip8(q0 - a1);
}

struct FInfo {
  int limit, ilevel, hev, inner;
};

void loop_filter(uint8_t* planes[3], const int64_t strides[3], const std::vector<FInfo>& finfo,
                 int mb_w, int mb_h, int ftype) {
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const FInfo& f = finfo[static_cast<size_t>(mb_y) * mb_w + mb_x];
      if (f.limit == 0) continue;
      for (int p = 0; p < 3; ++p) {
        if (p && ftype == 1) break;
        const int size = p == 0 ? 16 : 8;
        const int64_t s = strides[p];
        uint8_t* base = planes[p] + mb_y * size * s + mb_x * size;
        const bool simple = ftype == 1;
        const int inner_n = size == 16 ? 3 : 1;
        if (mb_x > 0)
          for (int i = 0; i < size; ++i)
            filter_edge(base + i * s, 1, f.limit + 4, f.ilevel, f.hev, simple ? 0 : 6);
        if (f.inner)
          for (int k = 1; k <= inner_n; ++k)
            for (int i = 0; i < size; ++i)
              filter_edge(base + i * s + 4 * k, 1, f.limit, f.ilevel, f.hev, simple ? 0 : 4);
        if (mb_y > 0)
          for (int i = 0; i < size; ++i)
            filter_edge(base + i, s, f.limit + 4, f.ilevel, f.hev, simple ? 0 : 6);
        if (f.inner)
          for (int k = 1; k <= inner_n; ++k)
            for (int i = 0; i < size; ++i)
              filter_edge(base + 4 * k * s + i, s, f.limit, f.ilevel, f.hev, simple ? 0 : 4);
      }
    }
  }
}

struct MBInfo {
  int seg, skip, i4, uvmode;
  int imodes[16];
};

int vp8_decode(const uint8_t* data, int64_t n, int width, int height, const int32_t* dc_table,
               const int32_t* ac_table, const uint8_t* proba0, const uint8_t* update,
               const uint8_t* bmodes, uint8_t* Y, uint8_t* U, uint8_t* V) {
  const int mb_w = (width + 15) >> 4, mb_h = (height + 15) >> 4;
  const int64_t ys = 16 * mb_w, uvs = 8 * mb_w;
  const int64_t first = (data[0] | (data[1] << 8) | (data[2] << 16)) >> 5;
  if (first > n - 10) return 3;
  BoolDec br(data, 10, 10 + first);
  // Frame header (segment and filter headers).
  bool segment = false, update_map = false, absolute = true;
  int quant[4] = {0}, filter_seg[4] = {0}, seg_probs[3] = {255, 255, 255};
  br.bit(0x80);
  br.bit(0x80);
  if (br.bit(0x80)) {
    segment = true;
    update_map = br.bit(0x80);
    if (br.bit(0x80)) {
      absolute = br.bit(0x80);
      for (int& q : quant) q = br.bit(0x80) ? br.signed_value(7) : 0;
      for (int& f : filter_seg) f = br.bit(0x80) ? br.signed_value(6) : 0;
    }
    if (update_map)
      for (int& p : seg_probs) p = br.bit(0x80) ? br.value_bits(8) : 255;
  }
  if (br.eof) return 4;
  const int simple = br.bit(0x80);
  const int level = br.value_bits(6);
  const int sharpness = br.value_bits(3);
  int ref_delta[4] = {0}, mode_delta[4] = {0};
  const int use_delta = br.bit(0x80);
  if (use_delta && br.bit(0x80)) {
    for (int& d : ref_delta)
      if (br.bit(0x80)) d = br.signed_value(6);
    for (int& d : mode_delta)
      if (br.bit(0x80)) d = br.signed_value(6);
  }
  if (br.eof) return 4;
  const int ftype = level == 0 ? 0 : simple ? 1 : 2;
  // Partitions.
  const int parts_n = 1 << br.value_bits(2);
  const int64_t rest = 10 + first;
  const int64_t size = n - rest;
  if (size < 3 * (parts_n - 1)) return 3;
  int64_t start = rest + 3 * (parts_n - 1), left = size - 3 * (parts_n - 1);
  std::vector<BoolDec> parts(parts_n);
  for (int p = 0; p < parts_n - 1; ++p) {
    int64_t ps = data[rest + 3 * p] | (data[rest + 3 * p + 1] << 8) | (data[rest + 3 * p + 2] << 16);
    ps = std::min(ps, left);
    parts[p] = BoolDec(data, start, start + ps);
    start += ps;
    left -= ps;
  }
  parts[parts_n - 1] = BoolDec(data, start, n);
  if (start >= n) return 3;
  // Quantizers.
  const int base = br.value_bits(7);
  int deltas[5];
  for (int& d : deltas) d = br.bit(0x80) ? br.signed_value(4) : 0;
  auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
  int dq[4][3][2];
  for (int s = 0; s < 4; ++s) {
    const int q = segment ? quant[s] + (absolute ? 0 : base) : base;
    dq[s][0][0] = dc_table[clip(q + deltas[0], 127)];
    dq[s][0][1] = ac_table[clip(q, 127)];
    dq[s][1][0] = dc_table[clip(q + deltas[1], 127)] * 2;
    dq[s][1][1] = std::max((ac_table[clip(q + deltas[2], 127)] * 101581) >> 16, 8);
    dq[s][2][0] = dc_table[clip(q + deltas[3], 117)];
    dq[s][2][1] = ac_table[clip(q + deltas[4], 127)];
  }
  br.bit(0x80);
  Probas probs;
  for (int t = 0, i = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p, ++i)
          probs[t][b][c][p] = static_cast<uint8_t>(br.bit(update[i]) ? br.value_bits(8) : proba0[i]);
  const int use_skip = br.bit(0x80);
  const int skip_p = use_skip ? br.value_bits(8) : 0;
  // Filter strengths.
  FInfo fstr[4][2];
  for (int s = 0; s < 4; ++s) {
    const int lbase = segment ? filter_seg[s] + (absolute ? 0 : level) : level;
    for (int i4 = 0; i4 < 2; ++i4) {
      int lv = lbase;
      if (use_delta) {
        lv += ref_delta[0];
        if (i4) lv += mode_delta[0];
      }
      lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
      if (lv > 0) {
        int il = lv;
        if (sharpness > 0) {
          il >>= sharpness > 4 ? 2 : 1;
          il = std::min(il, 9 - sharpness);
        }
        il = std::max(il, 1);
        fstr[s][i4] = {2 * lv + il, il, lv >= 40 ? 2 : lv >= 15 ? 1 : 0, 0};
      } else {
        fstr[s][i4] = {0, 0, 0, 0};
      }
    }
  }
  std::vector<int> intra_t(4 * mb_w, B_DC), nz_top(mb_w, 0), nz_dc_top(mb_w, 0);
  std::vector<uint8_t> top_y(16 * mb_w, 127), top_u(8 * mb_w, 127), top_v(8 * mb_w, 127);
  std::vector<FInfo> finfo;
  if (ftype) finfo.reserve(static_cast<size_t>(mb_w) * mb_h);
  std::vector<MBInfo> modes(mb_w);
  const int S = 21, CS = 9;
  uint8_t wy[S * 17], wu[CS * 9], wv[CS * 9];
  int16_t coeffs[24][16];
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    int intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MBInfo& m = modes[mb_x];
      m.seg = update_map ? (!br.bit(seg_probs[0]) ? br.bit(seg_probs[1])
                                                  : br.bit(seg_probs[2]) + 2)
                         : 0;
      m.skip = use_skip ? br.bit(skip_p) : 0;
      m.i4 = !br.bit(145);
      int* top = &intra_t[4 * mb_x];
      if (!m.i4) {
        const int ymode = br.bit(156) ? (br.bit(128) ? B_TM : B_HE) : (br.bit(163) ? B_VE : B_DC);
        m.imodes[0] = ymode;
        for (int i = 0; i < 4; ++i) top[i] = intra_l[i] = ymode;
      } else {
        for (int y = 0; y < 4; ++y) {
          int ym = intra_l[y];
          for (int x = 0; x < 4; ++x) {
            const uint8_t* prob = bmodes + (top[x] * 10 + ym) * 9;
            if (!br.bit(prob[0]))
              ym = B_DC;
            else if (!br.bit(prob[1]))
              ym = B_TM;
            else if (!br.bit(prob[2]))
              ym = B_VE;
            else if (!br.bit(prob[3]))
              ym = !br.bit(prob[4]) ? B_HE : !br.bit(prob[5]) ? B_RD : B_VR;
            else if (!br.bit(prob[6]))
              ym = B_LD;
            else if (!br.bit(prob[7]))
              ym = B_VL;
            else
              ym = !br.bit(prob[8]) ? B_HD : B_HU;
            top[x] = ym;
          }
          for (int x = 0; x < 4; ++x) m.imodes[4 * y + x] = top[x];
          intra_l[y] = ym;
        }
      }
      m.uvmode = !br.bit(142) ? B_DC : !br.bit(114) ? B_VE : br.bit(183) ? B_TM : B_HE;
    }
    if (br.eof) return 3;
    BoolDec& tb = parts[mb_y & (parts_n - 1)];
    int nz_left = 0, nz_dc_left = 0;
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const MBInfo& m = modes[mb_x];
      const int(*q)[2] = dq[m.seg];
      std::memset(coeffs, 0, sizeof(coeffs));
      int codes[24] = {0};
      bool not_skipped = false;
      if (!(use_skip && m.skip)) {
        int first_c = 0, typ = 3;
        if (!m.i4) {
          int16_t dc[16] = {0};
          const int ctx = nz_dc_top[mb_x] + nz_dc_left;
          const int nz = get_coeffs(tb, probs, 1, ctx, q[1], 0, dc);
          nz_dc_top[mb_x] = nz_dc_left = nz > 0;
          int16_t dcs[16];
          if (nz > 1) {
            wht(dc, dcs);
          } else {
            for (int16_t& v : dcs) v = w16((dc[0] + 3) >> 3);
          }
          for (int i = 0; i < 16; ++i) coeffs[i][0] = dcs[i];
          first_c = 1;
          typ = 0;
        }
        int tnz = nz_top[mb_x] & 0x0F, lnz = nz_left & 0x0F;
        for (int y = 0; y < 4; ++y) {
          int lb = (lnz >> y) & 1;
          for (int x = 0; x < 4; ++x) {
            const int ctx = lb + ((tnz >> x) & 1);
            int16_t* blk = coeffs[4 * y + x];
            const int nz = get_coeffs(tb, probs, typ, ctx, q[0], first_c, blk);
            lb = nz > first_c;
            tnz = (tnz & ~(1 << x)) | (lb << x);
            codes[4 * y + x] = nz_code(nz, blk[0] != 0);
          }
          lnz = (lnz & ~(1 << y)) | (lb << y);
        }
        int out_t = tnz, out_l = lnz;
        for (int ch = 0; ch < 2; ++ch) {
          int ct = (nz_top[mb_x] >> (4 + 2 * ch)) & 3, cl = (nz_left >> (4 + 2 * ch)) & 3;
          for (int y = 0; y < 2; ++y) {
            int lb = (cl >> y) & 1;
            for (int x = 0; x < 2; ++x) {
              const int ctx = lb + ((ct >> x) & 1);
              const int k = 16 + 4 * ch + 2 * y + x;
              const int nz = get_coeffs(tb, probs, 2, ctx, q[2], 0, coeffs[k]);
              lb = nz > 0;
              ct = (ct & ~(1 << x)) | (lb << x);
              codes[k] = nz_code(nz, coeffs[k][0] != 0);
            }
            cl = (cl & ~(1 << y)) | (lb << y);
          }
          out_t |= ct << (4 + 2 * ch);
          out_l |= cl << (4 + 2 * ch);
        }
        nz_top[mb_x] = out_t;
        nz_left = out_l;
        for (int c : codes) not_skipped |= c != 0;
      } else {
        nz_top[mb_x] = nz_left = 0;
        if (!m.i4) nz_dc_top[mb_x] = nz_dc_left = 0;
      }
      if (ftype) {
        FInfo f = fstr[m.seg][m.i4];
        f.inner = m.i4 | not_skipped;
        finfo.push_back(f);
      }
      // Work buffer edges.
      if (mb_x == 0) {
        for (int r = 1; r < 17; ++r) wy[r * S] = 129;
        for (int r = 1; r < 9; ++r) wu[r * CS] = wv[r * CS] = 129;
        wy[0] = wu[0] = wv[0] = mb_y > 0 ? 129 : 127;
      } else {
        for (int r = 0; r < 17; ++r) wy[r * S] = wy[r * S + 16];
        for (int r = 0; r < 9; ++r) {
          wu[r * CS] = wu[r * CS + 8];
          wv[r * CS] = wv[r * CS + 8];
        }
      }
      std::memcpy(wy + 1, &top_y[16 * mb_x], 16);
      std::memcpy(wu + 1, &top_u[8 * mb_x], 8);
      std::memcpy(wv + 1, &top_v[8 * mb_x], 8);
      if (mb_y == 0)
        std::memset(wy + 17, 127, 4);
      else if (mb_x == mb_w - 1)
        std::memset(wy + 17, top_y[16 * mb_x + 15], 4);
      else
        std::memcpy(wy + 17, &top_y[16 * (mb_x + 1)], 4);
      if (m.i4) {
        for (int r : {4, 8, 12}) std::memcpy(wy + r * S + 17, wy + 17, 4);
        for (int k = 0; k < 16; ++k) {
          uint8_t* at = wy + (1 + 4 * (k >> 2)) * S + 1 + 4 * (k & 3);
          pred4(m.imodes[k], at, S);
          transform(codes[k], coeffs[k], at, S);
        }
      } else {
        pred_block(m.imodes[0], 16, wy + S + 1, S, mb_x, mb_y);
        for (int k = 0; k < 16; ++k)
          transform(codes[k], coeffs[k], wy + (1 + 4 * (k >> 2)) * S + 1 + 4 * (k & 3), S);
      }
      for (int ch = 0; ch < 2; ++ch) {
        uint8_t* wb = ch ? wv : wu;
        const int b0 = 16 + 4 * ch;
        pred_block(m.uvmode, 8, wb + CS + 1, CS, mb_x, mb_y);
        int any = 0, ac = 0;
        for (int k = 0; k < 4; ++k) {
          any |= codes[b0 + k];
          ac |= codes[b0 + k] >= 2;
        }
        if (any)
          for (int k = 0; k < 4; ++k)
            transform(ac ? 3 : 1, coeffs[b0 + k], wb + (1 + 4 * (k >> 1)) * CS + 1 + 4 * (k & 1),
                      CS);
      }
      if (mb_y < mb_h - 1) {
        std::memcpy(&top_y[16 * mb_x], wy + 16 * S + 1, 16);
        std::memcpy(&top_u[8 * mb_x], wu + 8 * CS + 1, 8);
        std::memcpy(&top_v[8 * mb_x], wv + 8 * CS + 1, 8);
      }
      for (int r = 0; r < 16; ++r)
        std::memcpy(Y + (mb_y * 16 + r) * ys + mb_x * 16, wy + (r + 1) * S + 1, 16);
      for (int r = 0; r < 8; ++r) {
        std::memcpy(U + (mb_y * 8 + r) * uvs + mb_x * 8, wu + (r + 1) * CS + 1, 8);
        std::memcpy(V + (mb_y * 8 + r) * uvs + mb_x * 8, wv + (r + 1) * CS + 1, 8);
      }
      if (tb.eof) return 3;
    }
  }
  if (ftype) {
    uint8_t* planes[3] = {Y, U, V};
    const int64_t strides[3] = {ys, uvs, uvs};
    loop_filter(planes, strides, finfo, mb_w, mb_h, ftype);
  }
  return 0;
}

// --- YUV -> RGB ---------------------------------------------------------------

void upsample_line(const uint8_t* top, const uint8_t* cur, int width, bool bottom, int* out) {
  const uint8_t* near = bottom ? cur : top;
  const uint8_t* far = bottom ? top : cur;
  out[0] = (3 * near[0] + far[0] + 2) >> 2;
  const int pairs = (width - 1) >> 1;
  for (int j = 1; j <= pairs; ++j) {
    const int tl = top[j - 1], t = top[j], l = cur[j - 1], uv = cur[j];
    const int avg = tl + t + l + uv + 8;
    const int d12 = (avg + 2 * (t + l)) >> 3;
    const int d03 = (avg + 2 * (tl + uv)) >> 3;
    if (bottom) {
      out[2 * j - 1] = (d03 + l) >> 1;
      out[2 * j] = (d12 + uv) >> 1;
    } else {
      out[2 * j - 1] = (d12 + tl) >> 1;
      out[2 * j] = (d03 + t) >> 1;
    }
  }
  if (!(width & 1)) out[width - 1] = (3 * near[pairs] + far[pairs] + 2) >> 2;
}

inline int mult_hi(int v, int k) { return (v * k) >> 8; }
inline uint8_t yuv_clip8(int v) {
  return static_cast<uint8_t>((v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255);
}

}  // namespace

extern "C" int64_t wpt_vp8l(const uint8_t* data, int64_t n, int64_t pos, int32_t width,
                            int32_t height, int32_t alpha, const uint8_t* code_to_plane,
                            uint32_t* out) {
  VP8LCtx ctx{LBits{data, n, pos, std::max<int64_t>(8 * n, 64)}, code_to_plane, alpha != 0};
  try {
    std::vector<Transform> ts;
    std::vector<uint32_t> pix = decode_stream(ctx, width, height, true, &ts);
    pix = inverse_transforms(std::move(pix), ts, height);
    std::memcpy(out, pix.data(), sizeof(uint32_t) * static_cast<size_t>(width) * height);
    return 0;
  } catch (const Fail& f) {
    return f.status;
  }
}

extern "C" int64_t wpt_vp8(const uint8_t* data, int64_t n, int32_t width, int32_t height,
                           const int32_t* dc_table, const int32_t* ac_table,
                           const uint8_t* proba0, const uint8_t* update, const uint8_t* bmodes,
                           uint8_t* Y, uint8_t* U, uint8_t* V) {
  return vp8_decode(data, n, width, height, dc_table, ac_table, proba0, update, bmodes, Y, U, V);
}

extern "C" int64_t wpt_yuv_to_rgb(const uint8_t* Y, int64_t ystride, const uint8_t* U,
                                  const uint8_t* V, int64_t uvstride, int32_t width,
                                  int32_t height, uint8_t* rgb) {
  std::vector<int> u(width), v(width);
  for (int y = 0; y < height; ++y) {
    int top, cur;
    bool bottom = false;
    if (y == 0 || (height % 2 == 0 && y == height - 1)) {
      top = cur = y == 0 ? 0 : height / 2 - 1;
    } else if (y & 1) {
      top = (y - 1) / 2;
      cur = (y + 1) / 2;
    } else {
      top = y / 2 - 1;
      cur = y / 2;
      bottom = true;
    }
    upsample_line(U + top * uvstride, U + cur * uvstride, width, bottom, u.data());
    upsample_line(V + top * uvstride, V + cur * uvstride, width, bottom, v.data());
    const uint8_t* yr = Y + y * ystride;
    uint8_t* dst = rgb + static_cast<int64_t>(y) * width * 3;
    for (int x = 0; x < width; ++x) {
      const int yy = mult_hi(yr[x], 19077);
      dst[3 * x] = yuv_clip8(yy + mult_hi(v[x], 26149) - 14234);
      dst[3 * x + 1] = yuv_clip8(yy - mult_hi(u[x], 6419) - mult_hi(v[x], 13320) + 8708);
      dst[3 * x + 2] = yuv_clip8(yy + mult_hi(u[x], 33050) - 17685);
    }
  }
  return 0;
}

extern "C" int64_t wpt_alpha_unfilter(const uint8_t* in, int32_t width, int32_t height,
                                      int32_t method, uint8_t* out) {
  for (int y = 0; y < height; ++y) {
    const uint8_t* line = in + static_cast<int64_t>(y) * width;
    uint8_t* dst = out + static_cast<int64_t>(y) * width;
    const uint8_t* prev = y ? dst - width : nullptr;
    if (method == 0) {
      std::memcpy(dst, line, width);
    } else if (prev == nullptr || method == 1) {
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < width; ++x) pred = dst[x] = static_cast<uint8_t>(pred + line[x]);
    } else if (method == 2) {
      for (int x = 0; x < width; ++x) dst[x] = static_cast<uint8_t>(prev[x] + line[x]);
    } else {
      int top = prev[0], tl = top, left = top;
      for (int x = 0; x < width; ++x) {
        top = prev[x];
        const int g = clip8(left + top - tl);
        left = static_cast<uint8_t>(line[x] + g);
        tl = top;
        dst[x] = static_cast<uint8_t>(left);
      }
    }
  }
  return 0;
}
