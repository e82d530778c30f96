// JPEG 2000 tier 1: the code-block decoder of utils/jpeg2000.py::t1_plain,
// sample for sample (OpenJPEG 2.5.4's opj_t1_decode_cblk: the MQ decoder,
// the raw bypass reader, the significance, refinement and cleanup passes
// under every code-block style, and the ROI max-shift).
//
// wpt_j2k_t1 decodes every code-block of a tile. Each row of `table` is
// (w, h, orient, style, numbps, roishift, first segment, segments, output
// offset); each row of `segs` is (start in data, length, passes). The
// samples go to out[offset ...], row by row. Returns 0, or 1 where a block
// has 31 bit-planes or more (OpenJPEG gives up).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

const uint32_t kQe[47] = {
    0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801,
    0x3801, 0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801,
    0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201, 0x1C01, 0x1801, 0x1601,
    0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1, 0x08A1, 0x0521, 0x0441, 0x02A1,
    0x0221, 0x0141, 0x0111, 0x0085, 0x0049, 0x0025, 0x0015, 0x0009, 0x0005,
    0x0001, 0x5601};
const uint8_t kNmps[47] = {
    1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38,
    39, 40, 41, 42, 43, 44, 45, 45, 46};
const uint8_t kNlps[47] = {
    1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16, 17,
    18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
    35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
const uint8_t kSwitch[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0};

const int kAgg = 17, kUni = 18;
const int kLazy = 1, kReset = 2, kVsc = 8, kSegsym = 32;

uint8_t g_zc[4][3][3][5];
bool g_zc_ready = false;

void build_zc() {
  for (int orient = 0; orient < 4; ++orient)
    for (int h = 0; h < 3; ++h)
      for (int v = 0; v < 3; ++v)
        for (int d = 0; d < 5; ++d) {
          int n;
          if (orient == 3) {
            int hv = h + v;
            if (d == 0) n = hv == 0 ? 0 : hv == 1 ? 1 : 2;
            else if (d == 1) n = hv == 0 ? 3 : hv == 1 ? 4 : 5;
            else if (d == 2) n = hv == 0 ? 6 : 7;
            else n = 8;
          } else {
            int a = orient == 1 ? v : h, b = orient == 1 ? h : v;
            if (a == 0) {
              if (b == 0) n = d == 0 ? 0 : d == 1 ? 1 : 2;
              else n = b == 1 ? 3 : 4;
            } else if (a == 1) {
              n = b == 0 ? (d == 0 ? 5 : 6) : 7;
            } else {
              n = 8;
            }
          }
          g_zc[orient][h][v][d] = (uint8_t)n;
        }
  g_zc_ready = true;
}

struct Mq {
  std::vector<uint8_t> buf;
  const uint8_t* d = nullptr;
  size_t bp = 0;
  uint32_t a = 0, c = 0;
  int ct = 0;
  uint8_t st[19], mps[19];

  void reset() {
    std::memset(st, 0, sizeof st);
    std::memset(mps, 0, sizeof mps);
    st[kUni] = 46;
    st[kAgg] = 3;
    st[0] = 4;
  }
  void load(const uint8_t* seg, int64_t len) {
    buf.assign(seg, seg + len);
    buf.push_back(0xFF);
    buf.push_back(0xFF);
    d = buf.data();
    bp = 0;
  }
  void bytein() {
    uint32_t nxt = d[bp + 1];
    if (d[bp] == 0xFF) {
      if (nxt > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        ++bp;
        c += nxt << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += nxt << 8;
      ct = 8;
    }
  }
  void init(const uint8_t* seg, int64_t len) {
    load(seg, len);
    c = len == 0 ? (0xFFu << 16) : ((uint32_t)d[0] << 16);
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void raw_init(const uint8_t* seg, int64_t len) {
    load(seg, len);
    c = 0;
    ct = 0;
  }
  inline int decode(int cx) {
    int s = st[cx];
    uint32_t qe = kQe[s];
    int r;
    a -= qe;
    if ((c >> 16) < qe) {
      if (a < qe) {
        r = mps[cx];
        st[cx] = kNmps[s];
      } else {
        r = 1 - mps[cx];
        if (kSwitch[s]) mps[cx] = (uint8_t)(1 - mps[cx]);
        st[cx] = kNlps[s];
      }
      a = qe;
    } else {
      c -= qe << 16;
      if (a & 0x8000) return mps[cx];
      if (a < qe) {
        r = 1 - mps[cx];
        if (kSwitch[s]) mps[cx] = (uint8_t)(1 - mps[cx]);
        st[cx] = kNlps[s];
      } else {
        r = mps[cx];
        st[cx] = kNmps[s];
      }
    }
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (!(a & 0x8000));
    return r;
  }
  inline int raw() {
    if (ct == 0) {
      if (c == 0xFF) {
        if (d[bp] > 0x8F) {
          c = 0xFF;
          ct = 8;
        } else {
          c = d[bp++];
          ct = 7;
        }
      } else {
        c = d[bp++];
        ct = 8;
      }
    }
    --ct;
    return (int)((c >> ct) & 1);
  }
};

struct Block {
  int w, h, W, vsc;
  std::vector<uint8_t> sig, neg, pi, mu, nsig;
  std::vector<int32_t> val;
  // Per stripe column: significant samples plus neighbour counts.
  std::vector<int32_t> col;

  void setup(int w_, int h_, int vsc_) {
    w = w_;
    h = h_;
    W = w + 2;
    vsc = vsc_;
    size_t n = (size_t)W * (h + 2);
    sig.assign(n, 0);
    neg.assign(n, 0);
    pi.assign(n, 0);
    mu.assign(n, 0);
    nsig.assign(n, 0);
    val.assign(n, 0);
    col.assign((size_t)((h + 3) / 4 + 1) * W, 0);
  }
  inline int row_of(size_t k) const { return (int)(k / W) - 1; }
  inline void bump(size_t k) {
    int y = row_of(k);
    if (y < 0 || y >= h) return;
    int x = (int)(k % W) - 1;
    if (x < 0 || x >= w) return;
    ++nsig[k];
    ++col[(size_t)(y >> 2) * W + x + 1];
  }
  // Make sample k significant with sign s; neighbours count it, except
  // that under VSC a stripe's last row does not see the next stripe.
  inline void set_sig(size_t k, int s, int y, int x) {
    sig[k] = 1;
    neg[k] = (uint8_t)s;
    ++col[(size_t)(y >> 2) * W + x + 1];
    bump(k - 1);
    bump(k + 1);
    if (!(vsc && (y & 3) == 0)) {
      bump(k - W - 1);
      bump(k - W);
      bump(k - W + 1);
    }
    bump(k + W - 1);
    bump(k + W);
    bump(k + W + 1);
  }
  inline void nbh(size_t k, bool last, int& hh, int& vv, int& dd) const {
    hh = sig[k - 1] + sig[k + 1];
    if (last && vsc) {
      vv = sig[k - W];
      dd = sig[k - W - 1] + sig[k - W + 1];
    } else {
      vv = sig[k - W] + sig[k + W];
      dd = sig[k - W - 1] + sig[k - W + 1] + sig[k + W - 1] + sig[k + W + 1];
    }
  }
  inline int contrib(size_t j) const {
    return !sig[j] ? 0 : (neg[j] ? -1 : 1);
  }
  inline int sign_ctx(size_t k, bool last, int& xb) const {
    int hc = contrib(k - 1) + contrib(k + 1);
    hc = hc < -1 ? -1 : hc > 1 ? 1 : hc;
    int vc = contrib(k - W) + ((last && vsc) ? 0 : contrib(k + W));
    vc = vc < -1 ? -1 : vc > 1 ? 1 : vc;
    static const int ctx[3][3] = {{13, 12, 11}, {10, 9, 10}, {11, 12, 13}};
    static const int xr[3][3] = {{1, 1, 1}, {1, 0, 0}, {0, 0, 0}};
    xb = xr[hc + 1][vc + 1];
    return ctx[hc + 1][vc + 1];
  }
};

int decode_block(const uint8_t* data, const int64_t* row, const int64_t* segs,
                 int32_t* out, Block& b, Mq& mq) {
  const int w = (int)row[0], h = (int)row[1], orient = (int)row[2];
  const int style = (int)row[3];
  const int64_t numbps = row[4], roishift = row[5];
  const int64_t s0 = row[6], ns = row[7];
  int64_t sum = (roishift + numbps) & 0xFFFFFFFFLL;
  if (sum >= (1LL << 31)) sum -= 1LL << 32;
  int bpno = (int)sum;
  if (bpno >= 31) return 1;
  b.setup(w, h, style & kVsc);
  mq.reset();
  const uint8_t(*zc)[3][5] = g_zc[orient];
  int passtype = 2;
  const int W = b.W;
  for (int64_t si = s0; si < s0 + ns; ++si) {
    const int64_t* sg = segs + 3 * si;
    const bool raw = (bpno <= numbps - 4) && passtype < 2 && (style & kLazy);
    if (raw) mq.raw_init(data + sg[0], sg[1]);
    else mq.init(data + sg[0], sg[1]);
    for (int64_t p = 0; p < sg[2]; ++p) {
      if (bpno < 1) break;
      const int32_t one = (int32_t)1 << bpno, half = one >> 1;
      const int32_t oph = one | half;
      if (passtype == 0) {
        for (int y0 = 0; y0 < h; y0 += 4) {
          const int n = h - y0 < 4 ? h - y0 : 4;
          for (int x = 0; x < w; ++x) {
            if (!b.col[(size_t)(y0 >> 2) * W + x + 1]) continue;
            for (int ci = 0; ci < n; ++ci) {
              const size_t k = (size_t)(y0 + ci + 1) * W + x + 1;
              if (b.sig[k] || b.pi[k] || !b.nsig[k]) continue;
              const bool last = ci == 3;
              if (raw) {
                if (mq.raw()) {
                  int s = mq.raw();
                  b.val[k] = s ? -oph : oph;
                  b.set_sig(k, s, y0 + ci, x);
                }
              } else {
                int hh, vv, dd;
                b.nbh(k, last, hh, vv, dd);
                if (mq.decode(zc[hh][vv][dd])) {
                  int xb, cx = b.sign_ctx(k, last, xb);
                  int s = mq.decode(cx) ^ xb;
                  b.val[k] = s ? -oph : oph;
                  b.set_sig(k, s, y0 + ci, x);
                }
              }
              b.pi[k] = 1;
            }
          }
        }
      } else if (passtype == 1) {
        for (int y0 = 0; y0 < h; y0 += 4) {
          const int n = h - y0 < 4 ? h - y0 : 4;
          for (int x = 0; x < w; ++x) {
            if (!b.col[(size_t)(y0 >> 2) * W + x + 1]) continue;
            for (int ci = 0; ci < n; ++ci) {
              const size_t k = (size_t)(y0 + ci + 1) * W + x + 1;
              if (!b.sig[k] || b.pi[k]) continue;
              int v;
              if (raw) {
                v = mq.raw();
              } else {
                int cx;
                if (b.mu[k]) {
                  cx = 16;
                } else {
                  cx = b.nsig[k] ? 15 : 14;
                }
                v = mq.decode(cx);
              }
              b.val[k] += (v ^ (b.val[k] < 0)) ? half : -half;
              b.mu[k] = 1;
            }
          }
        }
      } else {
        for (int y0 = 0; y0 < h; y0 += 4) {
          const int n = h - y0 < 4 ? h - y0 : 4;
          for (int x = 0; x < w; ++x) {
            int ci = 0;
            const size_t k0 = (size_t)(y0 + 1) * W + x + 1;
            if (n == 4) {
              bool empty = !b.col[(size_t)(y0 >> 2) * W + x + 1];
              if (empty) {
                for (int r = 0; r < 4; ++r)
                  if (b.pi[k0 + (size_t)r * W]) { empty = false; break; }
              }
              if (empty) {
                if (!mq.decode(kAgg)) continue;
                ci = mq.decode(kUni) << 1;
                ci |= mq.decode(kUni);
                const size_t k = k0 + (size_t)ci * W;
                int xb, cx = b.sign_ctx(k, ci == 3, xb);
                int s = mq.decode(cx) ^ xb;
                b.val[k] = s ? -oph : oph;
                b.set_sig(k, s, y0 + ci, x);
                ++ci;
              }
            }
            for (int r = ci; r < n; ++r) {
              const size_t k = k0 + (size_t)r * W;
              if (b.sig[k] || b.pi[k]) continue;
              int hh, vv, dd;
              b.nbh(k, r == 3, hh, vv, dd);
              if (mq.decode(zc[hh][vv][dd])) {
                int xb, cx = b.sign_ctx(k, r == 3, xb);
                int s = mq.decode(cx) ^ xb;
                b.val[k] = s ? -oph : oph;
                b.set_sig(k, s, y0 + r, x);
              }
            }
          }
        }
        std::fill(b.pi.begin(), b.pi.end(), 0);
        if (style & kSegsym)
          for (int i = 0; i < 4; ++i) mq.decode(kUni);
      }
      if ((style & kReset) && !raw) mq.reset();
      if (++passtype == 3) {
        passtype = 0;
        --bpno;
      }
    }
  }
  // A shift of 31 or more clears the block, as OpenJPEG does (it passes
  // the bit-plane check above where the block's numbps is negative).
  const bool clear = roishift >= 31;
  const int32_t thresh =
      roishift && !clear ? ((int32_t)1 << roishift) : 0;
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      int32_t v = clear ? 0 : b.val[(size_t)(y + 1) * W + x + 1];
      if (roishift && !clear) {
        int32_t mag = v < 0 ? -v : v;
        if (mag >= thresh) {
          mag >>= roishift;
          v = v < 0 ? -mag : mag;
        }
      }
      out[(size_t)y * w + x] = v;
    }
  return 0;
}

}  // namespace

extern "C" int64_t wpt_j2k_t1(const uint8_t* data, int64_t len,
                              const int64_t* table, int64_t nblocks,
                              const int64_t* segs, int32_t* out) {
  (void)len;
  if (!g_zc_ready) build_zc();
  Block b;
  Mq mq;
  for (int64_t i = 0; i < nblocks; ++i) {
    const int64_t* row = table + 9 * i;
    if (decode_block(data, row, segs, out + row[8], b, mq)) return 1;
  }
  return 0;
}
