// The entropy decode of one JPEG scan, the same values bit for bit as the
// plain versions in utils/jpeg.py:
// * wpt_jpeg_scan: Huffman-coded scans, decode_scan (sequential), the four
//   progressive MCU decoders (jdphuff.c's decode_mcu_DC_first, _DC_refine,
//   _AC_first, _AC_refine) and decode_lossless_scan (jdlhuff.c: one
//   difference a sample);
// * wpt_jpeg_arith_scan: arithmetic-coded scans (jdarith.c's decode_mcu and
//   its four progressive decoders), decode_arith_scan;
// * wpt_jpeg_undifference: a lossless component's samples from its
//   differences (jdlossls.c), undifference.
// The caller hands in the scan's unstuffed restart intervals back to back,
// each data unit of an MCU with its component slot, block offsets and
// tables (Huffman lookups of 65,536 entries on the next 16 bits: code
// length << 8 | symbol, 17 << 8 where no code starts, as libjpeg reads a
// bad code; arithmetic table numbers),
// and the components' int32 coefficient (or difference) grids, which are
// written in place.

#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

// jpeg_natural_order with its 16 extra entries of 63.
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// The bits of one restart interval's bytes, zeros past their end.
struct Bits {
  const uint8_t* b;
  int64_t len;
  int64_t p;
  uint32_t window() const {
    const int64_t i = p >> 3;
    if (i + 4 <= len) {
      const uint8_t* q = b + i;
      return (uint32_t(q[0]) << 24) | (uint32_t(q[1]) << 16) |
             (uint32_t(q[2]) << 8) | q[3];
    }
    uint32_t w = 0;
    for (int64_t k = i; k < i + 4; ++k) w = (w << 8) | (k < len ? b[k] : 0u);
    return w;
  }
  int get(int n) {  // n in 0..16
    if (n == 0) return 0;
    int v = int((window() >> (32 - (p & 7) - n)) & ((1u << n) - 1));
    p += n;
    return v;
  }
  int symbol(const int32_t* t) {  // a bad code: 17 bits, symbol 0
    const int e = t[(window() >> (16 - (p & 7))) & 0xFFFF];
    p += e >> 8;
    return e & 255;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

inline int32_t wrap16(int64_t v) { return int32_t(int16_t(uint16_t(v))); }

enum Mode {
  kSequential = 0, kDCFirst, kDCRefine, kACFirst, kACRefine, kLossless
};

}  // namespace

// data/seg_start: the restart intervals' bytes (seg_start[i]..[i+1]), the
// first n_present of them found in the file and the rest missing (empty);
// mode, ss, se, al: the scan; n_mcus, interval, mcus_row: its MCUs; unit:
// the values a data unit (64 coefficients; 1 sample in a lossless scan);
// for each of the n_blocks data units of an MCU: the slot of its component
// (coefs[slot], its DC predictor), its block offset, the grid's blocks a
// MCU row, the component's blocks a MCU across, and its DC and AC tables
// (indices into tables, -1 where the scan needs none). Data that ends early
// is read as libjpeg-turbo reads it (its insufficient_data flag): the MCU
// (in a lossless scan, the MCU row) that runs past its interval's bytes
// reads zero bits, the interval's later ones are skipped (a lossless row
// flagged in skipped_rows), and only an interval whose RSTn was found
// clears the flag. out last_good: the last MCU begun with the flag clear.
// Returns 0: no data is an error.
extern "C" int64_t wpt_jpeg_scan(
    const uint8_t* data, const int64_t* seg_start, int64_t n_segs,
    int64_t n_present, int32_t mode, int32_t ss, int32_t se, int32_t al,
    int64_t n_mcus, int64_t interval, int64_t mcus_row, int32_t unit,
    int32_t n_blocks, const int32_t* slot, const int64_t* off,
    const int64_t* stride, const int64_t* mcu_w, const int32_t* dc_tab,
    const int32_t* ac_tab, int32_t** coefs, const int32_t** tables,
    int64_t* last_good, uint8_t* skipped_rows) {
  const int p1 = 1 << al, m1 = -(1 << al);
  bool is_short = false;
  *last_good = -1;
  for (int64_t seg = 0; seg < n_segs; ++seg) {
    const int64_t len = seg_start[seg + 1] - seg_start[seg];
    const int64_t first = seg * interval;
    const int64_t stop = first + interval < n_mcus ? first + interval : n_mcus;
    if (mode == kLossless) {
      if (seg < n_present) is_short = false;
    } else {
      if (is_short && seg >= n_present) continue;
      if (!is_short) *last_good = first;
      is_short = false;
    }
    Bits br{data + seg_start[seg], len, 0};
    int64_t preds[4] = {0, 0, 0, 0};
    int64_t eobrun = 0;
    for (int64_t m = first; m < stop; ++m) {
      const int64_t my = m / mcus_row, mx = m % mcus_row;
      if (mode == kLossless && mx == 0 && is_short) {
        skipped_rows[my] = 1;
        m += mcus_row - 1;
        continue;
      }
      for (int j = 0; j < n_blocks; ++j) {
        int32_t* coef =
            coefs[slot[j]] + (my * stride[j] + off[j] + mx * mcu_w[j]) * unit;
        if (mode == kLossless) {
          const int s = br.symbol(tables[dc_tab[j]]);
          coef[0] = s == 16 ? 32768 : s ? extend(br.get(s), s) : 0;
        } else if (mode == kSequential || mode == kDCFirst) {
          const int s = br.symbol(tables[dc_tab[j]]);
          const int diff = s ? extend(br.get(s), s) : 0;
          preds[slot[j]] += diff;
          coef[0] = mode == kSequential ? int32_t(preds[slot[j]])
                                        : wrap16(preds[slot[j]] << al);
          if (mode == kSequential) {
            const int32_t* t = tables[ac_tab[j]];
            for (int k = 1; k < 64;) {
              const int rs = br.symbol(t);
              const int r = rs >> 4, sz = rs & 15;
              if (sz) {
                k += r;
                coef[kNatural[k]] = extend(br.get(sz), sz);
                ++k;
              } else if (r == 15) {
                k += 16;
              } else {
                break;
              }
            }
          }
        } else if (mode == kDCRefine) {
          if (br.get(1)) coef[0] |= p1;
        } else if (mode == kACFirst) {
          if (eobrun > 0) {
            --eobrun;
          } else {
            const int32_t* t = tables[ac_tab[j]];
            for (int k = ss; k <= se; ++k) {
              const int rs = br.symbol(t);
              const int r = rs >> 4, s = rs & 15;
              if (s) {
                k += r;
                coef[kNatural[k]] = wrap16(int64_t(extend(br.get(s), s)) << al);
              } else if (r == 15) {
                k += 15;
              } else {
                eobrun = (int64_t(1) << r) + br.get(r) - 1;
                break;
              }
            }
          }
        } else {  // kACRefine
          int k = ss;
          if (eobrun == 0) {
            const int32_t* t = tables[ac_tab[j]];
            for (; k <= se; ++k) {
              const int rs = br.symbol(t);
              int r = rs >> 4, s = rs & 15;
              if (s) {
                s = br.get(1) ? p1 : m1;
              } else if (r != 15) {
                eobrun = (int64_t(1) << r) + br.get(r);
                break;
              }
              do {
                int32_t* c = coef + kNatural[k];
                if (*c != 0) {
                  if (br.get(1) && (*c & p1) == 0)
                    *c = wrap16(int64_t(*c) + (*c >= 0 ? p1 : m1));
                } else if (--r < 0) {
                  break;
                }
                ++k;
              } while (k <= se);
              if (s) coef[kNatural[k]] = s;
            }
          }
          if (eobrun > 0) {
            for (; k <= se; ++k) {
              int32_t* c = coef + kNatural[k];
              if (*c != 0 && br.get(1) && (*c & p1) == 0)
                *c = wrap16(int64_t(*c) + (*c >= 0 ? p1 : m1));
            }
            --eobrun;
          }
        }
      }
      if (mode == kLossless) {
        if (mx == mcus_row - 1) is_short = br.p > 8 * len;
      } else if (br.p > 8 * len) {
        is_short = true;
        break;
      } else if (m + 1 < stop) {
        *last_good = m + 1;
      }
    }
  }
  return 0;
}

namespace {

// ISO 10918-1 Table D.2 as jaricom.c packs it: Qe << 16 | Next_Index_MPS
// << 8 | Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed bin's.
const uint32_t kAritab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171};

// jdarith.c's decoder over one restart interval: the C and A registers,
// the bit counter (-16 before the first two bytes; -1 once the data proved
// bad), zeros past the interval's last byte.
struct QM {
  const uint8_t* b;
  int64_t len, pos = 0;
  int64_t c = 0, a = 0;
  int ct = -16;
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        const int data = pos < len ? b[pos] : 0;
        ++pos;
        c = (c << 8) | data;
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    const int nl = int(qe & 0xFF), nm = int((qe >> 8) & 0xFF);
    qe >>= 16;
    a -= qe;
    const int64_t temp = a << ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

// A restart interval's statistics, all 0 at its start but the fixed bin.
struct ArithState {
  uint8_t dc[16][64] = {};
  uint8_t ac[16][256] = {};
  uint8_t fixed = 113;
  int64_t last[4] = {0, 0, 0, 0};
  int ctx[4] = {0, 0, 0, 0};
};

// A DC difference into last[slot] (mod 2^16); false where the magnitude
// overflows.
bool arith_dc(QM& qm, ArithState& s, int slot, int tbl, const uint8_t* lo,
              const uint8_t* hi) {
  uint8_t* stats = s.dc[tbl];
  int st = s.ctx[slot];
  if (!qm.decode(stats + st)) {
    s.ctx[slot] = 0;
    return true;
  }
  const int sign = qm.decode(stats + st + 1);
  st += 2 + sign;
  int m = qm.decode(stats + st);
  if (m) {
    st = 20;
    while (qm.decode(stats + st)) {
      if ((m <<= 1) == 0x8000) return false;
      ++st;
    }
  }
  if (m < int((1L << lo[tbl]) >> 1))
    s.ctx[slot] = 0;
  else if (m > int((1L << hi[tbl]) >> 1))
    s.ctx[slot] = 12 + sign * 4;
  else
    s.ctx[slot] = 4 + sign * 4;
  int v = m;
  st += 14;
  while (m >>= 1)
    if (qm.decode(stats + st)) v |= m;
  v += 1;
  if (sign) v = -v;
  s.last[slot] = (s.last[slot] + v) & 0xFFFF;
  return true;
}

// A nonzero AC coefficient's sign and value; false where it overflows.
bool arith_ac_value(QM& qm, ArithState& s, uint8_t* stats, int st, int k,
                    int kx, int* out) {
  const int sign = qm.decode(&s.fixed);
  st += 2;
  int m = qm.decode(stats + st);
  if (m && qm.decode(stats + st)) {
    m <<= 1;
    st = k <= kx ? 189 : 217;
    while (qm.decode(stats + st)) {
      if ((m <<= 1) == 0x8000) return false;
      ++st;
    }
  }
  int v = m;
  st += 14;
  while (m >>= 1)
    if (qm.decode(stats + st)) v |= m;
  v += 1;
  *out = sign ? -v : v;
  return true;
}

}  // namespace

// An arithmetic-coded scan; the arguments as wpt_jpeg_scan takes them (dc_tab
// and ac_tab are table numbers 0..15), with the DAC conditioning of the 16
// tables: dc_lo (L), dc_hi (U) and ac_kx (Kx). Bad data is no error: as
// jdarith.c, the rest of its restart interval is left undecoded. Data that
// ends early, or a missing (empty) interval, reads zero bytes. Returns the
// bytes the last interval's decoder read (counting those past its end).
extern "C" int64_t wpt_jpeg_arith_scan(
    const uint8_t* data, const int64_t* seg_start, int64_t n_segs,
    int32_t mode, int32_t ss, int32_t se, int32_t al, int64_t n_mcus,
    int64_t interval, int64_t mcus_row, int32_t n_blocks,
    const int32_t* slot, const int64_t* off, const int64_t* stride,
    const int64_t* mcu_w, const int32_t* dc_tab, const int32_t* ac_tab,
    const uint8_t* dc_lo, const uint8_t* dc_hi, const uint8_t* ac_kx,
    int32_t** coefs) {
  const int p1 = 1 << al, m1 = -(1 << al);
  ArithState s;
  int64_t last_read = 0;  // bytes the last interval read, past its end too
  for (int64_t seg = 0; seg < n_segs; ++seg) {
    QM qm{data + seg_start[seg], seg_start[seg + 1] - seg_start[seg]};
    s = ArithState();
    const int64_t first = seg * interval;
    const int64_t stop = first + interval < n_mcus ? first + interval : n_mcus;
    for (int64_t m = first; m < stop; ++m) {
      if (qm.ct == -1 && mode != kDCRefine) break;
      const int64_t my = m / mcus_row, mx = m % mcus_row;
      for (int j = 0; j < n_blocks; ++j) {
        int32_t* coef =
            coefs[slot[j]] + (my * stride[j] + off[j] + mx * mcu_w[j]) * 64;
        if (mode == kSequential || mode == kDCFirst) {
          if (!arith_dc(qm, s, slot[j], dc_tab[j], dc_lo, dc_hi)) {
            qm.ct = -1;
            break;
          }
          coef[0] = wrap16(mode == kSequential ? s.last[slot[j]]
                                               : s.last[slot[j]] << al);
          if (mode == kDCFirst) continue;
          uint8_t* stats = s.ac[ac_tab[j]];
          const int kx = ac_kx[ac_tab[j]];
          for (int k = 1; k <= 63; ++k) {
            int st = 3 * (k - 1);
            if (qm.decode(stats + st)) break;
            while (!qm.decode(stats + st + 1)) {
              st += 3;
              if (++k > 63) {
                qm.ct = -1;
                break;
              }
            }
            int v;
            if (qm.ct == -1 || !arith_ac_value(qm, s, stats, st, k, kx, &v)) {
              qm.ct = -1;
              break;
            }
            coef[kNatural[k]] = wrap16(v);
          }
          if (qm.ct == -1) break;
        } else if (mode == kDCRefine) {
          if (qm.decode(&s.fixed)) coef[0] |= p1;
        } else if (mode == kACFirst) {
          uint8_t* stats = s.ac[ac_tab[j]];
          const int kx = ac_kx[ac_tab[j]];
          for (int k = ss; k <= se; ++k) {
            int st = 3 * (k - 1);
            if (qm.decode(stats + st)) break;
            while (!qm.decode(stats + st + 1)) {
              st += 3;
              if (++k > se) {
                qm.ct = -1;
                break;
              }
            }
            int v;
            if (qm.ct == -1 || !arith_ac_value(qm, s, stats, st, k, kx, &v)) {
              qm.ct = -1;
              break;
            }
            coef[kNatural[k]] = wrap16(int64_t(v) * p1);
          }
        } else {  // kACRefine
          uint8_t* stats = s.ac[ac_tab[j]];
          int kex = se;
          while (kex > 0 && coef[kNatural[kex]] == 0) --kex;
          for (int k = ss; k <= se; ++k) {
            int st = 3 * (k - 1);
            if (k > kex && qm.decode(stats + st)) break;
            for (;;) {
              int32_t* c = coef + kNatural[k];
              if (*c != 0) {
                if (qm.decode(stats + st + 2))
                  *c = wrap16(int64_t(*c) + (*c < 0 ? m1 : p1));
                break;
              }
              if (qm.decode(stats + st + 1)) {
                *c = qm.decode(&s.fixed) ? m1 : p1;
                break;
              }
              st += 3;
              if (++k > se) {
                qm.ct = -1;
                break;
              }
            }
            if (qm.ct == -1) break;
          }
        }
      }
    }
    last_read = qm.pos;
  }
  return last_read;
}

// A lossless component's samples from its (height, width) differences
// (row stride `stride`): jdlossls.c's undifferencers, a row flagged in
// first_rows from the left (2^(7 - pt) first), others from the sample above
// first and then by predictor psv (1-7) of Ra, Rb, Rc, all mod 2^16; the
// output shifted left by pt and cut to 8 bits.
extern "C" int64_t wpt_jpeg_undifference(
    const int32_t* diff, int64_t stride, int64_t width, int64_t height,
    const uint8_t* first_rows, int32_t psv, int32_t pt, uint8_t* out) {
  std::vector<int32_t> prev(static_cast<size_t>(width));
  std::vector<int32_t> cur(static_cast<size_t>(width));
  for (int64_t r = 0; r < height; ++r) {
    const int32_t* d = diff + r * stride;
    if (first_rows[r]) {
      int32_t ra = (d[0] + (1 << (7 - pt))) & 0xFFFF;
      cur[0] = ra;
      for (int64_t i = 1; i < width; ++i) cur[i] = ra = (d[i] + ra) & 0xFFFF;
    } else {
      int64_t ra = (d[0] + prev[0]) & 0xFFFF;
      cur[0] = int32_t(ra);
      for (int64_t i = 1; i < width; ++i) {
        const int64_t rb = prev[i], rc = prev[i - 1];
        int64_t pred;
        switch (psv) {
          case 1: pred = ra; break;
          case 2: pred = rb; break;
          case 3: pred = rc; break;
          case 4: pred = ra + rb - rc; break;
          case 5: pred = ra + ((rb - rc) >> 1); break;
          case 6: pred = rb + ((ra - rc) >> 1); break;
          default: pred = (ra + rb) >> 1; break;
        }
        ra = (d[i] + pred) & 0xFFFF;
        cur[i] = int32_t(ra);
      }
    }
    for (int64_t i = 0; i < width; ++i)
      out[r * width + i] = uint8_t(cur[i] << pt);
    prev.swap(cur);
  }
  return 0;
}

// Whether libjpeg-turbo, fed as Pillow feeds it, decodes `mcus` MCUs of
// sequential Huffman data from byte `start` of the file without asking
// for a byte past its end (utils/jpeg.py::huffman_reads_whole, the same
// answer): ends[i] is the end in the file of the interval's i-th data byte
// (FF 00 taking two), marker the end of the marker after them (-1: the
// data runs to the end of the file); each of the MCU's n_blocks blocks
// uses Huffman tables dc_tab and ac_tab (lookups of tables); fast: no
// restart interval, so jdhuff.c may take its fast path.
namespace {

struct SuspendOut {};
struct MarkerHit {};

struct Eof {
  const uint8_t* data;
  int64_t n, start, nb, marker, avail;
  const int64_t* ends;
  std::vector<uint8_t> ub, plain;
  int64_t u = 0, left = 0, p = 0;

  int64_t spos() const { return u ? ends[u - 1] : start; }
  uint32_t window(int64_t at) const {
    uint32_t w = 0;
    for (int k = 0; k < 4; ++k)
      w = (w << 8) | (at + k < nb ? ub[size_t(at + k)] : 0);
    return w;
  }
  void fill() {
    while (left < 57) {
      if (u == nb) {
        if (marker < 0 || marker > avail) throw SuspendOut{};
        throw MarkerHit{};
      }
      if (ends[u] > avail) throw SuspendOut{};
      ++u;
      left += 8;
    }
  }
  void fast_fill() {
    if (left <= 16) {
      if (u + 6 > nb) throw MarkerHit{};
      for (int k = 0; k < 6; ++k)
        if (!plain[size_t(u + k)]) throw MarkerHit{};
      u += 6;
      left += 48;
    }
  }
  void take(int bits, bool slow, int check) {
    if (slow && left < check) fill();
    left -= bits;
    p += bits;
  }
  int symbol(const int32_t* table, bool slow) {
    if (!slow)
      fast_fill();
    else if (left < 8)
      fill();
    const int32_t e = table[(window(p >> 3) >> (16 - (p & 7))) & 0xFFFF];
    const int length = e >> 8;
    if (!slow || length <= 8) {
      take(length, false, 0);
    } else {
      take(9, true, 9);
      for (int k = 9; k < length; ++k) take(1, true, 1);
    }
    return e & 255;
  }
};

}  // namespace

extern "C" int64_t wpt_jpeg_reads_whole(const uint8_t* data, int64_t n,
                                        int64_t start, const int64_t* ends,
                                        int64_t nb, int64_t marker,
                                        int64_t mcus, int32_t n_blocks,
                                        const int32_t* dc_tab,
                                        const int32_t* ac_tab,
                                        const int32_t* const* tables,
                                        int32_t fast) {
  Eof st{data, n, start, nb, marker, 0, ends, {}, {}};
  const int64_t block = 65536;
  st.avail = (start + block - 1) / block * block;
  if (st.avail > n) st.avail = n;
  for (int64_t i = 0; i < nb; ++i) {
    const int64_t q = i ? ends[i - 1] : start;
    st.ub.push_back(data[q]);
    st.plain.push_back(ends[i] - q <= 2);
  }
  const int64_t need_fast = 512 * int64_t(n_blocks);
  for (int64_t m = 0; m < mcus; ++m) {
    const int64_t u0 = st.u, left0 = st.left, p0 = st.p;
    bool slow_only = !fast;
    for (;;) {
      const bool slow = slow_only || st.avail - st.spos() < need_fast;
      try {
        for (int j = 0; j < n_blocks; ++j) {
          const int32_t* dct = tables[dc_tab[j]];
          const int32_t* act = tables[ac_tab[j]];
          const int s = st.symbol(dct, slow);
          if (s) {
            if (!slow) st.fast_fill();
            st.take(s, slow, s);
          }
          for (int k = 1; k < 64;) {
            const int rs = st.symbol(act, slow);
            const int r = rs >> 4, sz = rs & 15;
            if (sz) {
              if (!slow) st.fast_fill();
              st.take(sz, slow, sz);
              k += r + 1;
            } else if (r == 15) {
              k += 16;
            } else {
              break;
            }
          }
        }
        break;
      } catch (SuspendOut&) {
        if (st.avail >= n) return 0;
        st.avail = st.avail + block < n ? st.avail + block : n;
      } catch (MarkerHit&) {
        if (slow) return 1;
        slow_only = true;
      }
      st.u = u0, st.left = left0, st.p = p0;
    }
  }
  return 1;
}
