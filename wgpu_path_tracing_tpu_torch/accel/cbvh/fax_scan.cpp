// wpt_fax: libtiff's CCITT decoders (tif_fax3.c: Fax3DecodeRLE,
// Fax3Decode1D, Fax3Decode2D, Fax4Decode) on one TIFF strip or tile, the
// same samples and status as utils/fax.py::fax_plain, its plain version.
// Compression 2 is modified Huffman, 3 T.4 (two-dimensional rows under
// T4Options bit 0), 4 T.6, 32771 modified Huffman with each row padded to
// a 16-bit boundary of memory (RLEW: options is the parity of the strip's
// file offset, where libtiff reads it in the file's image). The bits come
// most significant first (the caller reverses fill order 2). Status: 0 decoded; 1 the data ran out, or
// a T.6 strip ended, before its last row; 2 a run array would overflow, or
// a T.6 strip ended on its first row.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum {
  kNull, kPass, kHoriz, kV0, kVR, kVL, kExt, kTermW, kTermB, kMakeUpW,
  kMakeUpB, kMakeUp, kEOL
};

struct Entry {
  int32_t state, width, param;
};

const char* kWhiteTerm[] = {
    "00110101", "000111",   "0111",     "1000",     "1011",     "1100",
    "1110",     "1111",     "10011",    "10100",    "00111",    "01000",
    "001000",   "000011",   "110100",   "110101",   "101010",   "101011",
    "0100111",  "0001100",  "0001000",  "0010111",  "0000011",  "0000100",
    "0101000",  "0101011",  "0010011",  "0100100",  "0011000",  "00000010",
    "00000011", "00011010", "00011011", "00010010", "00010011", "00010100",
    "00010101", "00010110", "00010111", "00101000", "00101001", "00101010",
    "00101011", "00101100", "00101101", "00000100", "00000101", "00001010",
    "00001011", "01010010", "01010011", "01010100", "01010101", "00100100",
    "00100101", "01011000", "01011001", "01011010", "01011011", "01001010",
    "01001011", "00110010", "00110011", "00110100"};
const char* kWhiteMakeUp[] = {
    "11011",     "10010",     "010111",    "0110111",   "00110110",
    "00110111",  "01100100",  "01100101",  "01101000",  "01100111",
    "011001100", "011001101", "011010010", "011010011", "011010100",
    "011010101", "011010110", "011010111", "011011000", "011011001",
    "011011010", "011011011", "010011000", "010011001", "010011010",
    "011000",    "010011011"};
const char* kBlackTerm[] = {
    "0000110111",   "010",          "11",           "10",
    "011",          "0011",         "0010",         "00011",
    "000101",       "000100",       "0000100",      "0000101",
    "0000111",      "00000100",     "00000111",     "000011000",
    "0000010111",   "0000011000",   "0000001000",   "00001100111",
    "00001101000",  "00001101100",  "00000110111",  "00000101000",
    "00000010111",  "00000011000",  "000011001010", "000011001011",
    "000011001100", "000011001101", "000001101000", "000001101001",
    "000001101010", "000001101011", "000011010010", "000011010011",
    "000011010100", "000011010101", "000011010110", "000011010111",
    "000001101100", "000001101101", "000011011010", "000011011011",
    "000001010100", "000001010101", "000001010110", "000001010111",
    "000001100100", "000001100101", "000001010010", "000001010011",
    "000000100100", "000000110111", "000000111000", "000000100111",
    "000000101000", "000001011000", "000001011001", "000000101011",
    "000000101100", "000001011010", "000001100110", "000001100111"};
const char* kBlackMakeUp[] = {
    "0000001111",    "000011001000",  "000011001001",  "000001011011",
    "000000110011",  "000000110100",  "000000110101",  "0000001101100",
    "0000001101101", "0000001001010", "0000001001011", "0000001001100",
    "0000001001101", "0000001110010", "0000001110011", "0000001110100",
    "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010",
    "0000001011011", "0000001100100", "0000001100101"};
const char* kExtMakeUp[] = {
    "00000001000",  "00000001100",  "00000001101",  "000000010010",
    "000000010011", "000000010100", "000000010101", "000000010110",
    "000000010111", "000000011100", "000000011101", "000000011110",
    "000000011111"};

void put(std::vector<Entry>& t, int bits, const std::string& code, int state,
         int param) {
  const int n = static_cast<int>(code.size());
  int value = 0;
  for (int i = 0; i < n; ++i) value |= (code[i] == '1') << i;
  for (int hi = 0; hi < (1 << (bits - n)); ++hi)
    t[value + (hi << n)] = Entry{state, n, param};
}

std::vector<Entry> run_table(int bits, const char** term, const char** makeup,
                             int term_state, int makeup_state) {
  std::vector<Entry> t(1 << bits, Entry{kNull, 0, 0});
  for (int i = 0; i < 64; ++i) put(t, bits, term[i], term_state, i);
  for (int i = 0; i < 27; ++i) put(t, bits, makeup[i], makeup_state, 64 * (i + 1));
  for (int i = 0; i < 13; ++i) put(t, bits, kExtMakeUp[i], kMakeUp, 1792 + 64 * i);
  put(t, bits, std::string(11, '0'), kEOL, 0);
  return t;
}

const std::vector<Entry>& main_table() {
  static const std::vector<Entry> t = [] {
    std::vector<Entry> m(128, Entry{kNull, 0, 0});
    put(m, 7, "1", kV0, 0);
    put(m, 7, "011", kVR, 1);
    put(m, 7, "000011", kVR, 2);
    put(m, 7, "0000011", kVR, 3);
    put(m, 7, "010", kVL, 1);
    put(m, 7, "000010", kVL, 2);
    put(m, 7, "0000010", kVL, 3);
    put(m, 7, "001", kHoriz, 0);
    put(m, 7, "0001", kPass, 0);
    put(m, 7, "0000001", kExt, 0);
    put(m, 7, "0000000", kEOL, 0);
    return m;
  }();
  return t;
}

const std::vector<Entry>& white_table() {
  static const std::vector<Entry> t =
      run_table(12, kWhiteTerm, kWhiteMakeUp, kTermW, kMakeUpW);
  return t;
}

const std::vector<Entry>& black_table() {
  static const std::vector<Entry> t =
      run_table(13, kBlackTerm, kBlackMakeUp, kTermB, kMakeUpB);
  return t;
}

uint8_t reversed(uint8_t b) {
  b = static_cast<uint8_t>((b & 0xF0) >> 4 | (b & 0x0F) << 4);
  b = static_cast<uint8_t>((b & 0xCC) >> 2 | (b & 0x33) << 2);
  return static_cast<uint8_t>((b & 0xAA) >> 1 | (b & 0x55) << 1);
}

struct EndOfData {};
struct Overflow {};

struct Fax {
  const uint8_t* src;
  int64_t n, cp = 0;
  uint64_t acc = 0;
  int64_t avail = 0;
  int64_t lastx, nruns;
  // libtiff's one run array of 2 * nruns (+1) entries: the current row's
  // runs from cur, the reference row's from ref.
  int64_t* cur;
  int64_t* ref;
  int eol = 0;
  int64_t a0 = 0, run = 0, pa = 0;

  Fax(const uint8_t* s, int64_t len, int64_t width, int64_t* runs,
      int64_t runs_len)
      : src(s), n(len), lastx(width), nruns((runs_len - 1) / 2),
        cur(runs), ref(runs + (runs_len - 1) / 2) {}

  void need(int64_t bits, bool two) {
    if (avail >= bits) return;
    if (cp >= n) {
      if (avail == 0) throw EndOfData{};
      avail = bits;
      return;
    }
    acc |= static_cast<uint64_t>(reversed(src[cp++])) << avail;
    avail += 8;
    if (two && avail < bits) {
      if (cp >= n) {
        avail = bits;
      } else {
        acc |= static_cast<uint64_t>(reversed(src[cp++])) << avail;
        avail += 8;
      }
    }
  }
  int64_t get(int bits) const { return static_cast<int64_t>(acc & ((1u << bits) - 1)); }
  void clr(int64_t bits) {
    avail -= bits;
    acc >>= bits;
  }
  Entry lookup(const std::vector<Entry>& t, int bits, bool two) {
    need(bits, two);
    const Entry e = t[get(bits)];
    clr(e.width);
    return e;
  }
  void setvalue(int64_t x) {
    if (pa >= nruns) throw Overflow{};
    cur[pa++] = run + x;
    a0 += x;
    run = 0;
  }
  void cleanup() {
    if (run) setvalue(0);
    if (a0 != lastx) {
      while (a0 > lastx && pa > 0) a0 -= cur[--pa];
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if (pa & 1) setvalue(0);
        setvalue(lastx - a0);
      } else if (a0 > lastx) {
        setvalue(lastx);
        setvalue(0);
      }
    }
  }
  void sync_eol() {
    if (eol == 0) {
      for (;;) {
        need(11, true);
        if (get(11) == 0) break;
        clr(1);
      }
    }
    for (;;) {
      need(8, false);
      if (get(8)) break;
      clr(8);
    }
    while (get(1) == 0) clr(1);
    clr(1);
    eol = 0;
  }
  // EXPAND1D; false where the data ran out.
  bool expand_1d() {
    try {
      for (;;) {
        for (int colour = 0; colour < 2; ++colour) {
          const std::vector<Entry>& t = colour ? black_table() : white_table();
          const int bits = colour ? 13 : 12;
          const int term = colour ? kTermB : kTermW;
          for (;;) {
            const Entry e = lookup(t, bits, true);
            if (e.state == kEOL) {
              eol = 1;
              cleanup();
              return true;
            }
            if (e.state == term) {
              setvalue(e.param);
              break;
            }
            if (e.state == kMakeUpW || e.state == kMakeUpB || e.state == kMakeUp) {
              a0 += e.param;
              run += e.param;
              continue;
            }
            cleanup();
            return true;
          }
          if (a0 >= lastx) {
            cleanup();
            return true;
          }
        }
        if (cur[pa - 1] == 0 && cur[pa - 2] == 0) pa -= 2;
      }
    } catch (EndOfData&) {
      cleanup();
      return false;
    }
  }
  bool horizontal_run(int colour) {
    const std::vector<Entry>& t = colour ? black_table() : white_table();
    const int bits = colour ? 13 : 12;
    const int term = colour ? kTermB : kTermW;
    const int makeup = colour ? kMakeUpB : kMakeUpW;
    for (;;) {
      const Entry e = lookup(t, bits, true);
      if (e.state == term) {
        setvalue(e.param);
        return true;
      }
      if (e.state == kMakeUp || e.state == makeup) {
        a0 += e.param;
        run += e.param;
        continue;
      }
      return false;
    }
  }
  // EXPAND2D; false where the data ran out.
  bool expand_2d() {
    int64_t pb = 0;
    int64_t b1 = ref[pb++];
    auto check_b1 = [&] {
      if (pa != 0) {
        while (b1 <= a0 && b1 < lastx) {
          if (pb + 1 >= nruns) throw Overflow{};
          b1 += ref[pb] + ref[pb + 1];
          pb += 2;
        }
      }
    };
    try {
      bool ended = false;
      while (a0 < lastx) {
        if (pa >= nruns) throw Overflow{};
        const Entry e = lookup(main_table(), 7, false);
        if (e.state == kPass) {
          check_b1();
          if (pb + 1 >= nruns) throw Overflow{};
          b1 += ref[pb++];
          run += b1 - a0;
          a0 = b1;
          b1 += ref[pb++];
        } else if (e.state == kHoriz) {
          const int first = static_cast<int>(pa & 1);
          if (!(horizontal_run(first) && horizontal_run(1 - first))) {
            ended = true;
            break;
          }
          check_b1();
        } else if (e.state == kV0 || e.state == kVR) {
          check_b1();
          setvalue(b1 - a0 + (e.state == kVR ? e.param : 0));
          if (pb >= nruns) throw Overflow{};
          b1 += ref[pb++];
        } else if (e.state == kVL) {
          check_b1();
          if (b1 < a0 + e.param) {
            ended = true;
            break;
          }
          setvalue(b1 - a0 - e.param);
          if (pb == 0) throw Overflow{};  // libtiff would read before the runs
          b1 -= ref[--pb];
        } else if (e.state == kExt) {
          cur[pa++] = lastx - a0;
          ended = true;
          break;
        } else {  // EOL
          cur[pa++] = lastx - a0;
          need(4, false);
          clr(4);
          eol = 1;
          ended = true;
          break;
        }
      }
      if (!ended && run) {
        if (run + a0 < lastx) {
          need(1, false);
          if (get(1)) {
            clr(1);
            setvalue(0);
          }
        } else {
          setvalue(0);
        }
      }
    } catch (EndOfData&) {
      cleanup();
      return false;
    }
    cleanup();
    return true;
  }
};

// _TIFFFax3fillruns into one row of 0/1 samples.
void fill(uint8_t* line, int64_t* runs, int64_t count, int64_t lastx) {
  if (count & 1) runs[count++] = 0;
  int64_t x = 0;
  for (int64_t i = 0; i < count; ++i) {
    int64_t r = runs[i] & 0xFFFFFFFFll;
    if (x + r > lastx || r > lastx) r = runs[i] = lastx - x;
    if (r) {
      std::memset(line + x, static_cast<int>(i & 1), r);
      x += r;
    }
  }
}

}  // namespace

// runs is the page's run array (utils/fax.py::fax_runs), kept across its
// strips and tiles as libtiff keeps it.
extern "C" int64_t wpt_fax(const uint8_t* src, int64_t n, int32_t compression,
                           int64_t lastx, int64_t rows, int32_t options,
                           int64_t* runs, int64_t runs_len, uint8_t* out) {
  const bool two_d = compression == 4 || (compression == 3 && (options & 1));
  Fax f(src, n, lastx, runs, runs_len);
  std::memset(out, 0, static_cast<size_t>(rows * lastx));
  if (two_d) {
    f.ref[0] = lastx;
    f.ref[1] = 0;
  }
  try {
    for (int64_t line = 0; line < rows; ++line) {
      uint8_t* dst = out + line * lastx;
      f.a0 = f.run = f.pa = 0;
      if (compression == 4) {
        const bool ok = f.expand_2d();
        if (!ok || f.eol) {
          fill(dst, f.cur, f.pa, lastx);
          return line ? 1 : 2;
        }
      } else if (compression == 3) {
        bool one_d = true;
        try {
          f.sync_eol();
          if (two_d) {
            f.need(1, false);
            one_d = f.get(1) != 0;
            f.clr(1);
          }
        } catch (EndOfData&) {
          f.cleanup();
          fill(dst, f.cur, f.pa, lastx);
          return 1;
        }
        const bool ok = (!two_d || one_d) ? f.expand_1d() : f.expand_2d();
        if (!ok) {
          fill(dst, f.cur, f.pa, lastx);
          return 1;
        }
      } else {
        if (!f.expand_1d()) {
          fill(dst, f.cur, f.pa, lastx);
          return 1;
        }
      }
      fill(dst, f.cur, f.pa, lastx);
      if (compression == 2) f.clr(f.avail & 7);
      if (compression == 32771) {
        f.clr(f.avail & 15);
        if (f.avail == 0 && ((options + f.cp) & 1)) f.cp++;
      }
      if (two_d) {
        if (compression == 4 || f.pa < f.nruns) {
          if (f.pa >= f.nruns) throw Overflow{};
          f.cur[f.pa++] = 0;
        }
        int64_t* t = f.cur;
        f.cur = f.ref;
        f.ref = t;
      }
    }
  } catch (Overflow&) {
    return 2;
  }
  return 0;
}
