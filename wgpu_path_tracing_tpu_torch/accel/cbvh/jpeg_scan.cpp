// The entropy decode of one JPEG scan: utils/jpeg.py's decode_scan
// (sequential) and its four progressive MCU decoders (jdphuff.c's
// decode_mcu_DC_first, _DC_refine, _AC_first, _AC_refine), the same
// coefficients bit for bit. The caller hands in the scan's unstuffed
// restart intervals back to back, each data unit of an MCU with its
// component slot, block offsets and Huffman lookups (65,536 entries on the
// next 16 bits: code length << 8 | symbol, 0 where no code starts), and the
// components' int32 coefficient grids, which are written in place.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// jpeg_natural_order with its 16 extra entries of 63.
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// One block reads at most 64 codes of 16 bits and 64 x 16 more: the
// padding keeps every read of a block inside the buffer, and the check
// after each block catches a read past the real bytes.
constexpr int64_t kPad = 1024;

struct Bits {
  const uint8_t* b;
  int64_t p;
  uint32_t window() const {
    const uint8_t* q = b + (p >> 3);
    return (uint32_t(q[0]) << 24) | (uint32_t(q[1]) << 16) |
           (uint32_t(q[2]) << 8) | q[3];
  }
  int get(int n) {  // n in 0..16
    if (n == 0) return 0;
    int v = int((window() >> (32 - (p & 7) - n)) & ((1u << n) - 1));
    p += n;
    return v;
  }
  int symbol(const int32_t* t) {  // -1: no code starts here
    int e = t[(window() >> (16 - (p & 7))) & 0xFFFF];
    if (e == 0) return -1;
    p += e >> 8;
    return e & 255;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

inline int32_t wrap16(int64_t v) { return int32_t(int16_t(uint16_t(v))); }

enum Mode { kSequential = 0, kDCFirst, kDCRefine, kACFirst, kACRefine };
enum Status { kOk = 0, kBadCode = 1, kTruncated = 2 };

}  // namespace

// data/seg_start: the restart intervals' bytes (seg_start[i]..[i+1]);
// mode, ss, se, al: the scan; n_mcus, interval, mcus_row: its MCUs; for
// each of the n_blocks data units of an MCU: the slot of its component
// (coefs[slot], its DC predictor), its block offset, the grid's blocks a
// MCU row, the component's blocks a MCU across, and its DC and AC tables
// (indices into tables, -1 where the scan needs none).
extern "C" int64_t wpt_jpeg_scan(
    const uint8_t* data, const int64_t* seg_start, int64_t n_segs,
    int32_t mode, int32_t ss, int32_t se, int32_t al, int64_t n_mcus,
    int64_t interval, int64_t mcus_row, int32_t n_blocks,
    const int32_t* slot, const int64_t* off, const int64_t* stride,
    const int64_t* mcu_w, const int32_t* dc_tab, const int32_t* ac_tab,
    int32_t** coefs, const int32_t** tables) {
  const int p1 = 1 << al, m1 = -(1 << al);
  std::vector<uint8_t> buf;
  for (int64_t seg = 0; seg < n_segs; ++seg) {
    const int64_t len = seg_start[seg + 1] - seg_start[seg];
    buf.assign(size_t(len + kPad), 0);
    if (len) std::memcpy(buf.data(), data + seg_start[seg], size_t(len));
    Bits br{buf.data(), 0};
    int64_t preds[4] = {0, 0, 0, 0};
    int64_t eobrun = 0;
    const int64_t first = seg * interval;
    const int64_t stop = first + interval < n_mcus ? first + interval : n_mcus;
    for (int64_t m = first; m < stop; ++m) {
      const int64_t my = m / mcus_row, mx = m % mcus_row;
      for (int j = 0; j < n_blocks; ++j) {
        int32_t* coef =
            coefs[slot[j]] + (my * stride[j] + off[j] + mx * mcu_w[j]) * 64;
        if (mode == kSequential || mode == kDCFirst) {
          const int s = br.symbol(tables[dc_tab[j]]);
          if (s < 0) return kBadCode;
          const int diff = s ? extend(br.get(s), s) : 0;
          preds[slot[j]] += diff;
          coef[0] = mode == kSequential ? int32_t(preds[slot[j]])
                                        : wrap16(preds[slot[j]] << al);
          if (mode == kSequential) {
            const int32_t* t = tables[ac_tab[j]];
            for (int k = 1; k < 64;) {
              const int rs = br.symbol(t);
              if (rs < 0) return kBadCode;
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
              if (rs < 0) return kBadCode;
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
              if (rs < 0) return kBadCode;
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
        if (br.p > 8 * len) return kTruncated;
      }
    }
  }
  return kOk;
}
