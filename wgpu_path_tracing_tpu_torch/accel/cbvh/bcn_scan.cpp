// The block-compressed texture decoders of the DDS reader, a block at a
// time, the same pixels as the plain NumPy versions (utils/bcn.py) and as
// Pillow 12.1.0's C bcn decoder: BC1-BC5 (BC5 unsigned and signed), BC6H
// (unsigned and signed) and BC7. wpt_bcn decodes the blocks of a w x h
// image in row order into its pixels (1, 3 or 4 bytes each), each block
// clipped to the image; the caller checks that the data holds them.
// wpt_blp_dxt is the other DXT decoder Pillow has, the Python one of its
// BLP plugin (utils/blp.py::dxt_plain): 5:6:5 endpoints shifted, not
// widened, and every block written whole.

#include <cstdint>
#include <cstring>

namespace {

struct Rgba {
  int r, g, b, a;
};

const uint16_t kSubsets2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80,
    0xc800, 0xffec, 0xfe80, 0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000,
    0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310, 0x3100, 0x8cce,
    0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c,
    0xaaaa, 0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696, 0xa55a,
    0x73ce, 0x13c8, 0x324c, 0x3bdc, 0x6996, 0xc33c, 0x9966, 0x0660,
    0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6, 0x639c,
    0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22};
const uint32_t kSubsets3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050,
    0x5555a0a0, 0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090,
    0x94949494, 0xa4a4a4a4, 0xa9a59450, 0x2a0a4250, 0xa5945040, 0x0a425054,
    0xa5a5a500, 0x55a0a0a0, 0xa8a85454, 0x6a6a4040, 0xa4a45000, 0x1a1a0500,
    0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400, 0xa08585a0, 0xaa821414,
    0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050, 0x24242424,
    0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
    0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600,
    0xaa444444, 0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580,
    0xaa141414, 0x96960000, 0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000,
    0x40804080, 0xa9a8a9a8, 0xaaaaaa44, 0x2a4a5254};
const uint8_t kAnchor2[64] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 2,  8,  2,  2,  8,  8,  15, 2,  8,  2,  2,  8,  8,  2,  2,
    15, 15, 6,  8,  2,  8,  15, 15, 2,  8,  2,  2,  2,  15, 15, 6,
    6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2,  15};
const uint8_t kAnchor3[64][2] = {
    {3, 15}, {3, 8}, {8, 15}, {3, 15}, {8, 15}, {3, 15}, {3, 15}, {8, 15},
    {8, 15}, {8, 15}, {6, 15}, {6, 15}, {6, 15}, {5, 15}, {3, 15}, {3, 8},
    {3, 15}, {3, 8}, {8, 15}, {3, 15}, {3, 15}, {3, 8}, {6, 15}, {8, 10},
    {3, 5}, {8, 15}, {6, 8}, {6, 10}, {8, 15}, {5, 15}, {10, 15}, {8, 15},
    {8, 15}, {3, 15}, {3, 15}, {5, 10}, {6, 10}, {8, 10}, {8, 9}, {10, 15},
    {6, 15}, {3, 15}, {8, 15}, {5, 15}, {3, 15}, {6, 15}, {6, 15}, {8, 15},
    {3, 15}, {3, 15}, {5, 15}, {5, 15}, {5, 15}, {8, 15}, {5, 15}, {10, 15},
    {5, 15}, {10, 15}, {8, 15}, {13, 15}, {3, 15}, {12, 15}, {3, 15}, {3, 8}};
const int kWeights2[4] = {0, 21, 43, 64};
const int kWeights3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const int kWeights4[16] = {0, 4, 9, 13, 17, 21, 26, 30,
                           34, 38, 43, 47, 51, 55, 60, 64};

const int* weights(int bits) {
  return bits == 2 ? kWeights2 : bits == 3 ? kWeights3 : kWeights4;
}

int subset(int ns, int partition, int i) {
  if (ns == 2) return (kSubsets2[partition] >> i) & 1;
  if (ns == 3) return (kSubsets3[partition] >> (2 * i)) & 3;
  return 0;
}

bool anchor(int ns, int partition, int i) {
  if (i == 0) return true;
  if (ns == 2) return i == kAnchor2[partition];
  if (ns == 3) return i == kAnchor3[partition][0] || i == kAnchor3[partition][1];
  return false;
}

int bits_at(const uint8_t* src, int pos, int count) {
  int v = 0;
  for (int k = 0; k < count; ++k) {
    const int p = pos + k;
    if (p < 128) v |= ((src[p >> 3] >> (p & 7)) & 1) << k;
  }
  return v;
}

// --- BC1-BC5 ----------------------------------------------------------

Rgba rgb565(int c) {
  int r = (c & 0xF800) >> 8, g = (c & 0x7E0) >> 3, b = (c & 0x1F) << 3;
  return {r | r >> 5, g | g >> 6, b | b >> 5, 255};
}

void bc1_colour(const uint8_t* src, bool separate_alpha, Rgba* px) {
  const int c0 = src[0] | src[1] << 8, c1 = src[2] | src[3] << 8;
  const uint32_t lut = static_cast<uint32_t>(src[4]) | src[5] << 8 |
                       src[6] << 16 | static_cast<uint32_t>(src[7]) << 24;
  Rgba p[4];
  p[0] = rgb565(c0);
  p[1] = rgb565(c1);
  if (c0 > c1 || separate_alpha) {
    p[2] = {(2 * p[0].r + p[1].r) / 3, (2 * p[0].g + p[1].g) / 3,
            (2 * p[0].b + p[1].b) / 3, 255};
    p[3] = {(p[0].r + 2 * p[1].r) / 3, (p[0].g + 2 * p[1].g) / 3,
            (p[0].b + 2 * p[1].b) / 3, 255};
  } else {
    p[2] = {(p[0].r + p[1].r) / 2, (p[0].g + p[1].g) / 2,
            (p[0].b + p[1].b) / 2, 255};
    p[3] = {0, 0, 0, 0};
  }
  for (int i = 0; i < 16; ++i) px[i] = p[(lut >> (2 * i)) & 3];
}

void alpha_ramp(const uint8_t* src, bool sign, int* out) {
  int a0 = src[0], a1 = src[1];
  if (sign) {
    a0 ^= 0x80;
    a1 ^= 0x80;
  }
  int a[8] = {a0, a1};
  if (a0 > a1) {
    for (int k = 1; k < 7; ++k) a[1 + k] = ((7 - k) * a0 + k * a1) / 7;
  } else {
    for (int k = 1; k < 5; ++k) a[1 + k] = ((5 - k) * a0 + k * a1) / 5;
    a[6] = 0;
    a[7] = 255;
  }
  uint64_t lut = 0;
  for (int k = 0; k < 6; ++k) lut |= static_cast<uint64_t>(src[2 + k]) << (8 * k);
  for (int i = 0; i < 16; ++i) out[i] = a[(lut >> (3 * i)) & 7];
}

// --- BC6H -------------------------------------------------------------

// (subsets, transformed, partition bits, endpoint bits, delta bits r, g, b)
const int kBc6Modes[14][7] = {
    {2, 1, 5, 10, 5, 5, 5}, {2, 1, 5, 7, 6, 6, 6},   {2, 1, 5, 11, 5, 4, 4},
    {2, 1, 5, 11, 4, 5, 4}, {2, 1, 5, 11, 4, 4, 5},  {2, 1, 5, 9, 5, 5, 5},
    {2, 1, 5, 8, 6, 5, 5},  {2, 1, 5, 8, 5, 6, 5},   {2, 1, 5, 8, 5, 5, 6},
    {2, 0, 5, 6, 6, 6, 6},  {1, 0, 0, 10, 10, 10, 10}, {1, 1, 0, 11, 9, 9, 9},
    {1, 1, 0, 12, 8, 8, 8}, {1, 1, 0, 16, 4, 4, 4}};
// Each mode's endpoint bits in stream order: endpoint (r0 g0 b0 r1 ... b3)
// * 16 + bit.
const uint8_t kBc6Packing[14][75] = {
    {
     116, 132, 180,   0,   1,   2,   3,   4,   5,   6,   7,   8,   9,  16,  17,
      18,  19,  20,  21,  22,  23,  24,  25,  32,  33,  34,  35,  36,  37,  38,
      39,  40,  41,  48,  49,  50,  51,  52, 164, 112, 113, 114, 115,  64,  65,
      66,  67,  68, 176, 160, 161, 162, 163,  80,  81,  82,  83,  84, 177, 128,
     129, 130, 131,  96,  97,  98,  99, 100, 178, 144, 145, 146, 147, 148, 179},
    {
     117, 164, 165,   0,   1,   2,   3,   4,   5,   6, 176, 177, 132,  16,  17,
      18,  19,  20,  21,  22, 133, 178, 116,  32,  33,  34,  35,  36,  37,  38,
     179, 181, 180,  48,  49,  50,  51,  52,  53, 112, 113, 114, 115,  64,  65,
      66,  67,  68,  69, 160, 161, 162, 163,  80,  81,  82,  83,  84,  85, 128,
     129, 130, 131,  96,  97,  98,  99, 100, 101, 144, 145, 146, 147, 148, 149},
    {
       0,   1,   2,   3,   4,   5,   6,   7,   8,   9,  16,  17,  18,  19,  20,
      21,  22,  23,  24,  25,  32,  33,  34,  35,  36,  37,  38,  39,  40,  41,
      48,  49,  50,  51,  52,  10, 112, 113, 114, 115,  64,  65,  66,  67,  26,
     176, 160, 161, 162, 163,  80,  81,  82,  83,  42, 177, 128, 129, 130, 131,
      96,  97,  98,  99, 100, 178, 144, 145, 146, 147, 148, 179,   0,   0,   0},
    {
       0,   1,   2,   3,   4,   5,   6,   7,   8,   9,  16,  17,  18,  19,  20,
      21,  22,  23,  24,  25,  32,  33,  34,  35,  36,  37,  38,  39,  40,  41,
      48,  49,  50,  51,  10, 164, 112, 113, 114, 115,  64,  65,  66,  67,  68,
      26, 160, 161, 162, 163,  80,  81,  82,  83,  42, 177, 128, 129, 130, 131,
      96,  97,  98,  99, 176, 178, 144, 145, 146, 147, 116, 179,   0,   0,   0},
    {
       0,   1,   2,   3,   4,   5,   6,   7,   8,   9,  16,  17,  18,  19,  20,
      21,  22,  23,  24,  25,  32,  33,  34,  35,  36,  37,  38,  39,  40,  41,
      48,  49,  50,  51,  10, 132, 112, 113, 114, 115,  64,  65,  66,  67,  26,
     176, 160, 161, 162, 163,  80,  81,  82,  83,  84,  42, 128, 129, 130, 131,
      96,  97,  98,  99, 177, 178, 144, 145, 146, 147, 180, 179,   0,   0,   0},
    {
       0,   1,   2,   3,   4,   5,   6,   7,   8, 132,  16,  17,  18,  19,  20,
      21,  22,  23,  24, 116,  32,  33,  34,  35,  36,  37,  38,  39,  40, 180,
      48,  49,  50,  51,  52, 164, 112, 113, 114, 115,  64,  65,  66,  67,  68,
     176, 160, 161, 162, 163,  80,  81,  82,  83,  84, 177, 128, 129, 130, 131,
      96,  97,  98,  99, 100, 178, 144, 145, 146, 147, 148, 179,   0,   0,   0},
    {
       0,   1,   2,   3,   4,   5,   6,   7, 164, 132,  16,  17,  18,  19,  20,
      21,  22,  23, 178, 116,  32,  33,  34,  35,  36,  37,  38,  39, 179, 180,
      48,  49,  50,  51,  52,  53, 112, 113, 114, 115,  64,  65,  66,  67,  68,
     176, 160, 161, 162, 163,  80,  81,  82,  83,  84, 177, 128, 129, 130, 131,
      96,  97,  98,  99, 100, 101, 144, 145, 146, 147, 148, 149,   0,   0,   0},
    {
       0,   1,   2,   3,   4,   5,   6,   7, 176, 132,  16,  17,  18,  19,  20,
      21,  22,  23, 117, 116,  32,  33,  34,  35,  36,  37,  38,  39, 165, 180,
      48,  49,  50,  51,  52, 164, 112, 113, 114, 115,  64,  65,  66,  67,  68,
      69, 160, 161, 162, 163,  80,  81,  82,  83,  84, 177, 128, 129, 130, 131,
      96,  97,  98,  99, 100, 178, 144, 145, 146, 147, 148, 179,   0,   0,   0},
    {
       0,   1,   2,   3,   4,   5,   6,   7, 177, 132,  16,  17,  18,  19,  20,
      21,  22,  23, 133, 116,  32,  33,  34,  35,  36,  37,  38,  39, 181, 180,
      48,  49,  50,  51,  52, 164, 112, 113, 114, 115,  64,  65,  66,  67,  68,
     176, 160, 161, 162, 163,  80,  81,  82,  83,  84,  85, 128, 129, 130, 131,
      96,  97,  98,  99, 100, 178, 144, 145, 146, 147, 148, 179,   0,   0,   0},
    {
       0,   1,   2,   3,   4,   5, 164, 176, 177, 132,  16,  17,  18,  19,  20,
      21, 117, 133, 178, 116,  32,  33,  34,  35,  36,  37, 165, 179, 181, 180,
      48,  49,  50,  51,  52,  53, 112, 113, 114, 115,  64,  65,  66,  67,  68,
      69, 160, 161, 162, 163,  80,  81,  82,  83,  84,  85, 128, 129, 130, 131,
      96,  97,  98,  99, 100, 101, 144, 145, 146, 147, 148, 149,   0,   0,   0},
    {
       0,   1,   2,   3,   4,   5,   6,   7,   8,   9,  16,  17,  18,  19,  20,
      21,  22,  23,  24,  25,  32,  33,  34,  35,  36,  37,  38,  39,  40,  41,
      48,  49,  50,  51,  52,  53,  54,  55,  56,  57,  64,  65,  66,  67,  68,
      69,  70,  71,  72,  73,  80,  81,  82,  83,  84,  85,  86,  87,  88,  89,
       0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0},
    {
       0,   1,   2,   3,   4,   5,   6,   7,   8,   9,  16,  17,  18,  19,  20,
      21,  22,  23,  24,  25,  32,  33,  34,  35,  36,  37,  38,  39,  40,  41,
      48,  49,  50,  51,  52,  53,  54,  55,  56,  10,  64,  65,  66,  67,  68,
      69,  70,  71,  72,  26,  80,  81,  82,  83,  84,  85,  86,  87,  88,  42,
       0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0},
    {
       0,   1,   2,   3,   4,   5,   6,   7,   8,   9,  16,  17,  18,  19,  20,
      21,  22,  23,  24,  25,  32,  33,  34,  35,  36,  37,  38,  39,  40,  41,
      48,  49,  50,  51,  52,  53,  54,  55,  11,  10,  64,  65,  66,  67,  68,
      69,  70,  71,  27,  26,  80,  81,  82,  83,  84,  85,  86,  87,  43,  42,
       0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0},
    {
       0,   1,   2,   3,   4,   5,   6,   7,   8,   9,  16,  17,  18,  19,  20,
      21,  22,  23,  24,  25,  32,  33,  34,  35,  36,  37,  38,  39,  40,  41,
      48,  49,  50,  51,  15,  14,  13,  12,  11,  10,  64,  65,  66,  67,  31,
      30,  29,  28,  27,  26,  80,  81,  82,  83,  47,  46,  45,  44,  43,  42,
       0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0}};

int extend(int v, int prec) {
  if (v & (1 << (prec - 1))) v |= ~((1 << prec) - 1);
  return v & 0xFFFF;
}

int unquantize(int v, int prec, bool sign) {
  if (!sign) {
    if (prec >= 15) return v;
    if (v == 0) return 0;
    if (v == (1 << prec) - 1) return 0xFFFF;
    return ((v << 15) + 0x4000) >> (prec - 1);
  }
  int x = static_cast<int16_t>(static_cast<uint16_t>(v));
  if (prec >= 16) return x;
  const bool neg = x < 0;
  if (neg) x = -x;
  if (x != 0) {
    x = x >= (1 << (prec - 1)) - 1 ? 0x7FFF : ((x << 15) + 0x4000) >> (prec - 1);
  }
  return neg ? -x : x;
}

float half_to_float(uint16_t h) {
  union {
    uint32_t u;
    float f;
  } o, m;
  m.u = 0x77800000;
  o.u = static_cast<uint32_t>(h & 0x7FFF) << 13;
  o.f *= m.f;
  m.u = 0x47800000;
  if (o.f >= m.f) o.u |= 255u << 23;
  o.u |= static_cast<uint32_t>(h & 0x8000) << 16;
  return o.f;
}

int finalize(int v, bool sign) {
  float f;
  if (sign) {
    f = v < 0 ? half_to_float(static_cast<uint16_t>(0x8000 | ((-v) * 31) / 32))
              : half_to_float(static_cast<uint16_t>((v * 31) / 32));
  } else {
    f = half_to_float(static_cast<uint16_t>((v * 31) / 64));
  }
  if (f < 0.0f) return 0;
  if (f > 1.0f) return 255;
  return static_cast<int>(f * 255.0f);
}

void bc6(const uint8_t* src, bool sign, uint8_t* out) {
  const int m5 = src[0] & 0x1F;
  int mode, bit = 5;
  if ((m5 & 3) < 2) {
    mode = m5 & 3;
    bit = 2;
  } else if ((m5 & 3) == 2) {
    mode = 2 + (m5 >> 2);
  } else {
    mode = 10 + (m5 >> 2);
  }
  if (mode >= 14) {
    std::memset(out, 0, 48);
    return;
  }
  const int* info = kBc6Modes[mode];
  const int ns = info[0], tr = info[1], pb = info[2], epb = info[3];
  const int epbits = mode < 2 ? 75 : mode < 10 ? 72 : 60;
  int e[12] = {0};
  for (int i = 0; i < epbits; ++i) {
    const int d = kBc6Packing[mode][i];
    e[d >> 4] |= bits_at(src, bit + i, 1) << (d & 15);
  }
  bit += epbits;
  const int partition = bits_at(src, bit, pb);
  bit += pb;
  const int numep = ns == 2 ? 12 : 6;
  if (sign) {
    for (int c = 0; c < 3; ++c) e[c] = extend(e[c], epb);
  }
  if (sign || tr) {
    for (int i = 3; i < numep; i += 3)
      for (int c = 0; c < 3; ++c) e[i + c] = extend(e[i + c], info[4 + c]);
  }
  if (tr) {
    const int mask = (1 << epb) - 1;
    for (int i = 3; i < numep; i += 3)
      for (int c = 0; c < 3; ++c) e[i + c] = (e[i + c] + e[c]) & mask;
  }
  int u[12];
  for (int i = 0; i < numep; ++i) u[i] = unquantize(e[i], epb, sign);
  const int ib = ns == 2 ? 3 : 4;
  const int* w = weights(ib);
  for (int i = 0; i < 16; ++i) {
    const int s = 6 * subset(ns, partition, i);
    const int width = ib - (anchor(ns, partition, i) ? 1 : 0);
    const int wt = w[bits_at(src, bit, width)];
    bit += width;
    for (int c = 0; c < 3; ++c) {
      const int v = (u[s + c] * (64 - wt) + u[s + 3 + c] * wt) >> 6;
      out[3 * i + c] = static_cast<uint8_t>(finalize(v, sign));
    }
  }
}

// --- BC7 --------------------------------------------------------------

// (subsets, partition bits, rotation bits, index-selection bits, colour
// bits, alpha bits, p-bit an endpoint, p-bit a subset, index bits, second
// index bits)
const int kBc7Modes[8][10] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

int expand(int v, int bits) {
  v = (v << (8 - bits)) & 0xFF;
  return v | (v >> bits);
}

void bc7(const uint8_t* src, uint8_t* out) {
  if (src[0] == 0) {
    for (int i = 0; i < 16; ++i) {
      out[4 * i] = out[4 * i + 1] = out[4 * i + 2] = 0;
      out[4 * i + 3] = 255;
    }
    return;
  }
  int mode = 0;
  while (!(src[0] & (1 << mode))) ++mode;
  const int* info = kBc7Modes[mode];
  const int ns = info[0], ib = info[8], ib2 = info[9];
  int cb = info[4], ab = info[5];
  int bit = mode + 1;
  const int partition = bits_at(src, bit, info[1]);
  bit += info[1];
  const int rotation = bits_at(src, bit, info[2]);
  bit += info[2];
  const int index_sel = bits_at(src, bit, info[3]);
  bit += info[3];
  const int numep = 2 * ns;
  int e[6][4];
  for (int c = 0; c < 3; ++c)
    for (int i = 0; i < numep; ++i) {
      e[i][c] = bits_at(src, bit, cb);
      bit += cb;
    }
  for (int i = 0; i < numep; ++i) {
    if (ab) {
      e[i][3] = bits_at(src, bit, ab);
      bit += ab;
    } else {
      e[i][3] = 255;
    }
  }
  const int chans = ab ? 4 : 3;
  if (info[6]) {
    ++cb;
    if (ab) ++ab;
    for (int i = 0; i < numep; ++i) {
      const int p = bits_at(src, bit++, 1);
      for (int c = 0; c < chans; ++c) e[i][c] = e[i][c] << 1 | p;
    }
  }
  if (info[7]) {
    ++cb;
    if (ab) ++ab;
    for (int i = 0; i < numep; i += 2) {
      const int p = bits_at(src, bit++, 1);
      for (int j = 0; j < 2; ++j)
        for (int c = 0; c < chans; ++c) e[i + j][c] = e[i + j][c] << 1 | p;
    }
  }
  for (int i = 0; i < numep; ++i) {
    for (int c = 0; c < 3; ++c) e[i][c] = expand(e[i][c], cb);
    if (ab) e[i][3] = expand(e[i][3], ab);
  }
  const int* cw = weights(ib);
  const int* aw = weights(ab && ib2 ? ib2 : ib);
  int cbit = bit;
  int abit = cbit + 16 * ib - ns;
  for (int i = 0; i < 16; ++i) {
    const int s = 2 * subset(ns, partition, i);
    const int width = ib - (anchor(ns, partition, i) ? 1 : 0);
    const int i0 = bits_at(src, cbit, width);
    cbit += width;
    int wc = cw[i0], wa = cw[i0];
    if (ab && ib2) {
      const int width2 = ib2 - (i == 0 ? 1 : 0);
      const int i1 = bits_at(src, abit, width2);
      abit += width2;
      if (index_sel) {
        wc = aw[i1];
        wa = cw[i0];
      } else {
        wc = cw[i0];
        wa = aw[i1];
      }
    }
    int px[4];
    for (int c = 0; c < 3; ++c)
      px[c] = ((64 - wc) * e[s][c] + wc * e[s + 1][c] + 32) >> 6;
    px[3] = ((64 - wa) * e[s][3] + wa * e[s + 1][3] + 32) >> 6;
    if (rotation) {
      const int t = px[rotation - 1];
      px[rotation - 1] = px[3];
      px[3] = t;
    }
    for (int c = 0; c < 4; ++c) out[4 * i + c] = static_cast<uint8_t>(px[c]);
  }
}

// The colours of a DXT colour block as Pillow's BlpImagePlugin reads them:
// 5:6:5 values shifted into the top bits; DXT1 takes the 3-colour palette
// (with transparent black) where c0 <= c1, DXT3 and DXT5 never.
void blp_colour(const uint8_t* src, bool dxt1, Rgba* px) {
  const int c0 = src[0] | src[1] << 8, c1 = src[2] | src[3] << 8;
  const uint32_t lut = static_cast<uint32_t>(src[4]) | src[5] << 8 |
                       src[6] << 16 | static_cast<uint32_t>(src[7]) << 24;
  Rgba p[4];
  p[0] = {(c0 >> 11 & 0x1F) << 3, (c0 >> 5 & 0x3F) << 2, (c0 & 0x1F) << 3, 255};
  p[1] = {(c1 >> 11 & 0x1F) << 3, (c1 >> 5 & 0x3F) << 2, (c1 & 0x1F) << 3, 255};
  if (c0 > c1 || !dxt1) {
    p[2] = {(2 * p[0].r + p[1].r) / 3, (2 * p[0].g + p[1].g) / 3,
            (2 * p[0].b + p[1].b) / 3, 255};
    p[3] = {(p[0].r + 2 * p[1].r) / 3, (p[0].g + 2 * p[1].g) / 3,
            (p[0].b + 2 * p[1].b) / 3, 255};
  } else {
    p[2] = {(p[0].r + p[1].r) / 2, (p[0].g + p[1].g) / 2,
            (p[0].b + p[1].b) / 2, 255};
    p[3] = {0, 0, 0, 0};
  }
  for (int i = 0; i < 16; ++i) px[i] = p[(lut >> (2 * i)) & 3];
}

}  // namespace

// kind: 1 DXT1, 3 DXT3, 5 DXT5. out: (4 bh) rows of (4 bw) pixels of 4
// bytes (DXT3, DXT5, DXT1 with alpha) or 3 (DXT1 without), every block
// whole; the caller checks that the data holds the blocks.
extern "C" int64_t wpt_blp_dxt(const uint8_t* data, int64_t n, int64_t pos,
                               int32_t kind, int32_t alpha, int64_t bw,
                               int64_t bh, uint8_t* out) {
  const int size = kind == 1 ? 8 : 16;
  const int bpp = kind == 1 && !alpha ? 3 : 4;
  if (pos + bw * bh * size > n) return 1;
  const int64_t row = 4 * bw * bpp;
  Rgba col[16];
  int a[16];
  for (int64_t by = 0; by < bh; ++by) {
    for (int64_t bx = 0; bx < bw; ++bx) {
      const uint8_t* src = data + pos + (by * bw + bx) * size;
      blp_colour(kind == 1 ? src : src + 8, kind == 1, col);
      if (kind == 3) {
        for (int i = 0; i < 16; ++i) col[i].a = ((src[i / 2] >> (4 * (i & 1))) & 15) * 17;
      } else if (kind == 5) {
        alpha_ramp(src, false, a);
        for (int i = 0; i < 16; ++i) col[i].a = a[i];
      }
      for (int i = 0; i < 16; ++i) {
        uint8_t* px = out + (4 * by + i / 4) * row + (4 * bx + i % 4) * bpp;
        px[0] = static_cast<uint8_t>(col[i].r);
        px[1] = static_cast<uint8_t>(col[i].g);
        px[2] = static_cast<uint8_t>(col[i].b);
        if (bpp == 4) px[3] = static_cast<uint8_t>(col[i].a);
      }
    }
  }
  return 0;
}

// format: 1 BC1, 2 BC2, 3 BC3, 4 BC4, 5 BC5, 6 BC5 signed, 7 BC6H, 8 BC6H
// signed, 9 BC7. out: h x w pixels of 1 (BC4), 3 (BC5, BC6H) or 4 bytes.
extern "C" int64_t wpt_bcn(const uint8_t* data, int64_t n, int64_t pos,
                           int32_t format, int64_t w, int64_t h,
                           uint8_t* out) {
  const int size = (format == 1 || format == 4) ? 8 : 16;
  const int chans = format == 4 ? 1 : (format == 5 || format == 6 ||
                                       format == 7 || format == 8) ? 3 : 4;
  const int64_t bw = (w + 3) / 4, bh = (h + 3) / 4;
  if (pos + bw * bh * size > n) return 1;
  uint8_t px[64];
  Rgba col[16];
  int a[16], g[16];
  for (int64_t by = 0; by < bh; ++by) {
    for (int64_t bx = 0; bx < bw; ++bx) {
      const uint8_t* src = data + pos + (by * bw + bx) * size;
      switch (format) {
        case 1:
        case 2:
        case 3:
          bc1_colour(format == 1 ? src : src + 8, format != 1, col);
          if (format == 2) {
            for (int i = 0; i < 16; ++i) col[i].a = ((src[i / 2] >> (4 * (i & 1))) & 15) * 17;
          } else if (format == 3) {
            alpha_ramp(src, false, a);
            for (int i = 0; i < 16; ++i) col[i].a = a[i];
          }
          for (int i = 0; i < 16; ++i) {
            px[4 * i] = static_cast<uint8_t>(col[i].r);
            px[4 * i + 1] = static_cast<uint8_t>(col[i].g);
            px[4 * i + 2] = static_cast<uint8_t>(col[i].b);
            px[4 * i + 3] = static_cast<uint8_t>(col[i].a);
          }
          break;
        case 4:
          alpha_ramp(src, false, a);
          for (int i = 0; i < 16; ++i) px[i] = static_cast<uint8_t>(a[i]);
          break;
        case 5:
        case 6:
          alpha_ramp(src, format == 6, a);
          alpha_ramp(src + 8, format == 6, g);
          for (int i = 0; i < 16; ++i) {
            px[3 * i] = static_cast<uint8_t>(a[i]);
            px[3 * i + 1] = static_cast<uint8_t>(g[i]);
            px[3 * i + 2] = format == 6 ? 128 : 0;
          }
          break;
        case 7:
        case 8:
          bc6(src, format == 8, px);
          break;
        default:
          bc7(src, px);
      }
      for (int j = 0; j < 4; ++j) {
        const int64_t y = 4 * by + j;
        if (y >= h) break;
        for (int i = 0; i < 4; ++i) {
          const int64_t x = 4 * bx + i;
          if (x >= w) break;
          std::memcpy(out + (y * w + x) * chans, px + (4 * j + i) * chans, chans);
        }
      }
    }
  }
  return 0;
}
