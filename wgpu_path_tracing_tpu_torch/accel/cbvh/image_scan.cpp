// The per-packet loops of the LDR image readers, the same bytes as the
// plain versions in Python:
// * wpt_tga_rle: TGA run-length data (utils/tga.py::rle_plain), raw
//   packets running on across rows, run packets held within their row;
// * wpt_bmp_rle: BMP RLE8 and RLE4 data as Pillow's BmpRleDecoder reads it
//   (utils/bmp.py::rle_plain), its escapes included;
// * wpt_packbits: libtiff's PackBitsDecode of one TIFF strip or tile
//   (utils/tiff.py::packbits_plain);
// * wpt_lzw: libtiff's LZWDecode (new-style codes) or LZWDecodeCompat
//   (old-style) of one TIFF strip or tile (utils/tiff.py::lzw_plain);
// * wpt_gif_lzw: Pillow's GifDecode of one GIF frame's LZW data, rows in
//   interlace order (utils/gif.py::lzw_plain);
// * wpt_qoi: Pillow's QoiDecoder op loop (utils/qoi.py::ops_plain);
// * wpt_pcx_rle: Pillow's PcxDecode run-length loop
//   (utils/pcx.py::rle_plain);
// * wpt_sgi_rle: Pillow's SgiRleDecode of every row of every channel
//   (utils/sgi.py::rle_plain);
// * wpt_packbits_rows: Pillow's PackbitsDecode, a packet that crosses the
//   end of a row dropping its rest (utils/psd.py::packbits_rows_plain);
// * wpt_sun_rle: Pillow's SunRleDecode, runs spilling across rows
//   (utils/sun.py::rle_plain);
// * wpt_msp_rle: Pillow's MspDecoder, every row of the row map
//   (utils/msp.py::rle_plain);
// * wpt_icns_rle: Pillow's ICNS read_32 of one channel
//   (utils/icns.py::rle_plain);
// * wpt_fli: Pillow's FliDecode of one FLI/FLC frame's chunks
//   (utils/fli.py::fli_plain);
// * wpt_bit_decode: Pillow's BitDecode at an IM file's "F;n" arguments
//   (utils/im.py::bits_plain);
// * wpt_thunder: libtiff's ThunderDecode of one TIFF strip, a row at a
//   time (utils/tiff.py::thunder_plain).
// Each writes into a buffer the caller sizes and returns a status or the
// count of bytes written.

#include <cstdint>
#include <cstring>
#include <vector>

// Status: 0 done, 1 the data runs out, 2 a run packet crosses its row.
extern "C" int64_t wpt_tga_rle(const uint8_t* data, int64_t n, int64_t pos,
                               int32_t bpp, int64_t width, int64_t pixels,
                               uint8_t* out) {
  const int64_t row = width * bpp;
  const int64_t total = pixels * bpp;
  int64_t x = 0, done = 0;
  while (done < total) {
    if (pos >= n) return 1;
    const int head = data[pos];
    int64_t k = ((head & 0x7F) + 1) * static_cast<int64_t>(bpp);
    if (head & 0x80) {
      if (pos + 1 + bpp > n) return 1;
      if (x + k > row) return 2;
      uint8_t* dst = out + done + x;
      for (int64_t i = 0; i < k; i += bpp) std::memcpy(dst + i, data + pos + 1, bpp);
      pos += 1 + bpp;
      x += k;
      if (x == row) {
        done += row;
        x = 0;
      }
    } else {
      if (pos + 1 + k > n) return 1;
      int64_t src = pos + 1;
      pos += 1 + k;
      while (k > 0 && done < total) {
        const int64_t take = k < row - x ? k : row - x;
        std::memcpy(out + done + x, data + src, take);
        src += take;
        k -= take;
        x += take;
        if (x == row) {
          done += row;
          x = 0;
        }
      }
    }
  }
  return 0;
}

// Returns the pixels decoded, at most count (the first count land in out;
// the last packet may run past them); *status gets 1 where a delta escape
// is cut short (Pillow raises), else 0.
extern "C" int64_t wpt_bmp_rle(const uint8_t* data, int64_t n, int64_t pos,
                               int32_t rle4, int64_t width, int64_t count,
                               uint8_t* out, int64_t* status) {
  int64_t len = 0, x = 0;
  *status = 0;
  // Writes past count are dropped: the decode keeps count pixels.
  auto put = [&](uint8_t v) {
    if (len < count) out[len] = v;
    ++len;
  };
  while (len < count) {
    if (pos + 2 > n) break;
    int64_t k = data[pos];
    const int byte = data[pos + 1];
    pos += 2;
    if (k) {
      if (x + k > width) k = width - x > 0 ? width - x : 0;
      for (int64_t i = 0; i < k && len < count; ++i)
        put(rle4 ? ((i & 1) ? (byte & 0x0F) : (byte >> 4))
                 : static_cast<uint8_t>(byte));
      x += k;
    } else if (byte == 0) {
      const int64_t pad = (width - len % width) % width;
      for (int64_t i = 0; i < pad && len < count; ++i) put(0);
      x = 0;
    } else if (byte == 1) {
      break;
    } else if (byte == 2) {
      if (pos + 2 > n) break;
      pos += 2;
      if (pos + 2 > n) {
        *status = 1;
        break;
      }
      const int64_t skip = data[pos] + data[pos + 1] * width;
      pos += 2;
      for (int64_t i = 0; i < skip && len < count; ++i) put(0);
      if (len >= count) break;
      x = len % width;
    } else {
      const int64_t want = rle4 ? byte / 2 : byte;
      const int64_t got = n - pos < want ? n - pos : want;
      for (int64_t i = 0; i < got; ++i) {
        const uint8_t b = data[pos + i];
        if (rle4) {
          put(b >> 4);
          put(b & 0x0F);
        } else {
          put(b);
        }
      }
      pos += got;
      if (got < want) break;
      x += byte;
      if (pos % 2) pos += 1;
    }
  }
  return len < count ? len : count;
}

// Returns the bytes written into size (fewer where the data runs out).
extern "C" int64_t wpt_packbits(const uint8_t* src, int64_t n, int64_t size,
                                uint8_t* out) {
  int64_t pos = 0, len = 0;
  while (pos < n && len < size) {
    int64_t k = src[pos++];
    if (k >= 128) k -= 256;
    if (k < 0) {
      if (k == -128) continue;
      k = -k + 1;
      if (k > size - len) k = size - len;
      if (pos >= n) break;
      std::memset(out + len, src[pos++], k);
      len += k;
    } else {
      k += 1;
      if (k > size - len) k = size - len;
      if (n - pos < k) break;
      std::memcpy(out + len, src + pos, k);
      pos += k;
      len += k;
    }
  }
  return len;
}

// Status: 0 done, 1 a corrupted table, 2 not enough data; *written gets
// the bytes written. old_style reads libtiff's LZWDecodeCompat codes:
// least significant bit first, the width growing one code later.
extern "C" int64_t wpt_lzw(const uint8_t* src, int64_t n, int64_t size,
                           int32_t old_style, uint8_t* out, int64_t* written) {
  *written = 0;
  constexpr int kClear = 256, kEoi = 257, kFirst = 258, kMax = 5119;
  std::vector<int32_t> prefix(kMax), length(kMax);
  std::vector<uint8_t> suffix(kMax), first(kMax);
  for (int i = 0; i < 256; ++i) {
    prefix[i] = -1;
    length[i] = 1;
    suffix[i] = first[i] = static_cast<uint8_t>(i);
  }
  std::vector<uint8_t> scratch;
  int width = 9;
  int64_t next = kFirst, len = 0, bitpos = 0;
  const int64_t nbits = 8 * n;
  const int64_t late = old_style ? 1 : 0;
  int64_t prev = -2;  // -2: no clear code yet; -1: just after one
  int status = 2;
  while (len < size) {
    if (bitpos + width > nbits) break;
    const int64_t at = bitpos >> 3;
    uint32_t word = 0;
    int64_t code;
    if (old_style) {
      for (int i = 2; i >= 0; --i)
        word = (word << 8) | (at + i < n ? src[at + i] : 0);
      code = (word >> (bitpos & 7)) & ((1u << width) - 1);
    } else {
      for (int i = 0; i < 3; ++i)
        word = (word << 8) | (at + i < n ? src[at + i] : 0);
      code = (word >> (24 - width - (bitpos & 7))) & ((1u << width) - 1);
    }
    bitpos += width;
    if (code == kEoi) break;
    if (code == kClear) {
      next = kFirst;
      width = 9;
      prev = -1;
      continue;
    }
    int64_t entry;
    if (prev == -2) {
      status = 1;
      break;
    }
    if (prev == -1) {
      if (code >= 256) {
        status = 1;
        break;
      }
      entry = code;
    } else if (code <= next) {
      if (next >= kMax) {
        status = 1;
        break;
      }
      prefix[next] = static_cast<int32_t>(prev);
      length[next] = length[prev] + 1;
      first[next] = first[prev];
      suffix[next] = code < next ? first[code] : first[prev];
      entry = code;
      ++next;
    } else {
      status = 1;
      break;
    }
    // The entry's bytes, written back to front, cut at size.
    const int64_t m = length[entry];
    scratch.resize(m);
    int64_t c = entry;
    for (int64_t i = m - 1; i >= 0; --i) {
      scratch[i] = suffix[c];
      c = prefix[c];
    }
    const int64_t take = m < size - len ? m : size - len;
    std::memcpy(out + len, scratch.data(), take);
    len += take;
    prev = code;
    if (next + 1 - late >= (int64_t{1} << width) && width < 12) ++width;
  }
  *written = len;
  if (status == 1) return 1;
  return len < size ? 2 : 0;
}

// Status: 0 the frame's last pixel written, 1 broken data, 2 the data (or
// an end code) comes before the last pixel, 3 a minimum code size over 12;
// *written gets the pixels written.
extern "C" int64_t wpt_gif_lzw(const uint8_t* data, int64_t n, int32_t bits,
                               int64_t width, int64_t height, int32_t interlace,
                               uint8_t* out, int64_t* written) {
  *written = 0;
  if (bits < 0 || bits > 12) return 3;
  const int clear = 1 << bits, end = clear + 1;
  int64_t step = interlace ? 8 : 1;
  int il = interlace ? 1 : 0;
  std::vector<uint8_t> tab(4096, 0);
  std::vector<int32_t> link(4096, 0);
  std::vector<uint8_t> stack;
  stack.reserve(4096);
  int64_t pos = 0, blocksize = 0, x = 0, y = 0, count = 0;
  uint32_t bitbuffer = 0;
  int bitcount = 0, state = 1, next = 0, codesize = 0, codemask = 0;
  int lastcode = 0, lastdata = 0;
  size_t pending = 0;  // bytes of stack still to output (from its end)
  uint8_t one;
  while (true) {
    if (state == 1) {
      next = clear + 2;
      codesize = bits + 1;
      codemask = (1 << codesize) - 1;
      pending = 0;
      state = 2;
    }
    const uint8_t* str;
    size_t len;
    std::vector<uint8_t> chunk;
    if (pending) {
      chunk.assign(stack.rbegin(), stack.rbegin() + pending);
      str = chunk.data();
      len = pending;
      pending = 0;
    } else {
      while (bitcount < codesize) {
        if (blocksize > 0) {
          bitbuffer |= static_cast<uint32_t>(data[pos++]) << bitcount;
          --blocksize;
          bitcount += 8;
        } else {
          if (pos >= n || n - pos < data[pos] + 1) {
            *written = count;
            return 2;
          }
          blocksize = data[pos++];
        }
      }
      int c = static_cast<int>(bitbuffer & static_cast<uint32_t>(codemask));
      bitbuffer >>= codesize;
      bitcount -= codesize;
      if (c == clear) {
        if (state != 2) state = 1;
        continue;
      }
      if (c == end) {
        *written = count;
        return 2;
      }
      if (state == 2) {
        if (c > clear) {
          *written = count;
          return 1;
        }
        lastdata = lastcode = c;
        state = 3;
      } else {
        const int thiscode = c;
        if (c > next) {
          *written = count;
          return 1;
        }
        stack.clear();
        if (c == next) {
          stack.push_back(static_cast<uint8_t>(lastdata));
          c = lastcode;
        }
        while (c >= clear) {
          if (stack.size() >= 4096 || c >= 4096) {
            *written = count;
            return 1;
          }
          stack.push_back(tab[c]);
          c = link[c];
        }
        lastdata = c;
        if (next < 4096) {
          tab[next] = static_cast<uint8_t>(c);
          link[next] = lastcode;
          if (next == codemask && codesize < 12) {
            ++codesize;
            codemask = (1 << codesize) - 1;
          }
          ++next;
        }
        lastcode = thiscode;
        pending = stack.size();
      }
      one = static_cast<uint8_t>(lastdata);
      str = &one;
      len = 1;
    }
    if (y >= height) {
      *written = count;
      return 1;
    }
    for (size_t k = 0; k < len; ++k) {
      out[y * width + x] = str[k];
      ++count;
      if (++x >= width) {
        x = 0;
        y += step;
        while (y >= height) {
          if (il == 1) {
            y = 4;
            il = 2;
          } else if (il == 2) {
            step = 4;
            y = 2;
            il = 3;
          } else if (il == 3) {
            step = 2;
            y = 1;
            il = 0;
          } else {
            *written = count;
            return 0;
          }
        }
      }
    }
  }
}


// Status: 0 done, 1 the data runs out.
extern "C" int64_t wpt_qoi(const uint8_t* data, int64_t n, int64_t pos,
                           int64_t pixels, uint8_t* out) {
  uint8_t index[64][4];
  bool seen[64] = {false};
  uint8_t prev[4] = {0, 0, 0, 255};
  int64_t k = 0;
  while (k < pixels) {
    if (pos >= n) return 1;
    const int b = data[pos++];
    uint8_t v[4];
    if (b == 0xFE) {
      if (pos + 3 > n) return 1;
      v[0] = data[pos];
      v[1] = data[pos + 1];
      v[2] = data[pos + 2];
      v[3] = prev[3];
      pos += 3;
    } else if (b == 0xFF) {
      if (pos + 4 > n) return 1;
      std::memcpy(v, data + pos, 4);
      pos += 4;
    } else if ((b >> 6) == 0) {
      if (seen[b]) {
        std::memcpy(v, index[b], 4);
      } else {
        v[0] = v[1] = v[2] = v[3] = 0;
      }
    } else if ((b >> 6) == 1) {
      v[0] = static_cast<uint8_t>(prev[0] + ((b >> 4) & 3) - 2);
      v[1] = static_cast<uint8_t>(prev[1] + ((b >> 2) & 3) - 2);
      v[2] = static_cast<uint8_t>(prev[2] + (b & 3) - 2);
      v[3] = prev[3];
    } else if ((b >> 6) == 2) {
      if (pos >= n) return 1;
      const int second = data[pos++];
      const int dg = (b & 0x3F) - 32;
      v[0] = static_cast<uint8_t>(prev[0] + dg + (second >> 4) - 8);
      v[1] = static_cast<uint8_t>(prev[1] + dg);
      v[2] = static_cast<uint8_t>(prev[2] + dg + (second & 15) - 8);
      v[3] = prev[3];
    } else {
      int64_t run = (b & 0x3F) + 1;
      if (run > pixels - k) run = pixels - k;
      for (int64_t i = 0; i < run; ++i) std::memcpy(out + 4 * (k + i), prev, 4);
      k += run;
      continue;
    }
    std::memcpy(prev, v, 4);
    const int h = (v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64;
    std::memcpy(index[h], v, 4);
    seen[h] = true;
    std::memcpy(out + 4 * k, v, 4);
    ++k;
  }
  return 0;
}

// Status: 0 done, 1 the data runs out, 2 a run crosses the end of a row.
extern "C" int64_t wpt_pcx_rle(const uint8_t* data, int64_t n, int64_t pos,
                               int64_t row_bytes, int64_t rows, uint8_t* out) {
  const int64_t total = row_bytes * rows;
  int64_t at = 0, x = 0;
  while (at < total) {
    if (pos >= n) return 1;
    const int b = data[pos];
    if ((b & 0xC0) == 0xC0) {
      if (pos + 1 >= n) return 1;
      const int64_t k = b & 0x3F;
      if (x + k > row_bytes) return 2;
      std::memset(out + at, data[pos + 1], k);
      at += k;
      x += k;
      pos += 2;
    } else {
      out[at++] = static_cast<uint8_t>(b);
      ++x;
      ++pos;
    }
    if (x == row_bytes) x = 0;
  }
  return 0;
}

// One channel of one SGI RLE row (Pillow's expandrow / expandrow2): 0, 1
// (the chain had not ended by its last counted packet) or -1 (overrun).
static int sgi_row(const uint8_t* data, int64_t pos, int64_t count_in,
                   uint8_t* row, int ch, int z, int bpc, int64_t w,
                   int64_t last) {
  int64_t x = 0;
  int64_t dst = static_cast<int64_t>(ch) * bpc;
  const int64_t step = static_cast<int64_t>(z) * bpc;
  for (int64_t k = count_in; k > 0; --k) {
    if (pos + bpc - 1 > last) return -1;
    const int pixel = data[pos + bpc - 1];
    pos += bpc;
    if (k == 1 && pixel != 0) return 1;
    const int count = pixel & 0x7F;
    if (!count) return 0;
    if (x + count > w) return -1;
    x += count;
    if (pixel & 0x80) {
      if (pos + static_cast<int64_t>(bpc) * count > last) return -1;
      for (int i = 0; i < count; ++i) {
        std::memcpy(row + dst, data + pos, bpc);
        pos += bpc;
        dst += step;
      }
    } else {
      if ((bpc == 2 ? pos + 2 : pos) > last) return -1;
      for (int i = 0; i < count; ++i) {
        std::memcpy(row + dst, data + pos, bpc);
        dst += step;
      }
      pos += bpc;
    }
  }
  return 0;
}

// Rows in stored order (bottom first), w * z * bpc bytes each, zero past a
// chain that had not ended. Status: 0, 1 the tables do not fit in the
// file, 2 a row outside the file or overrunning its width.
extern "C" int64_t wpt_sgi_rle(const uint8_t* data, int64_t n, int64_t w,
                               int64_t h, int32_t z, int32_t bpc,
                               uint8_t* out) {
  const int64_t header = 512;
  const int64_t size = n - header;
  const int64_t tablen = static_cast<int64_t>(z) * h;
  if (size < 8 * tablen) return 1;
  auto be32 = [&](int64_t at) {
    return static_cast<uint32_t>(data[at]) << 24 |
           static_cast<uint32_t>(data[at + 1]) << 16 |
           static_cast<uint32_t>(data[at + 2]) << 8 | data[at + 3];
  };
  const int64_t row_bytes = w * z * bpc;
  std::vector<uint8_t> row(row_bytes, 0);
  for (int64_t y = 0; y < h; ++y) {
    for (int ch = 0; ch < z; ++ch) {
      const int64_t t = y + ch * h;
      const uint32_t off = be32(header + 4 * t);
      const uint32_t len = be32(header + 4 * (tablen + t));
      if (off < header) return 2;
      // Pillow passes the length on as a signed int (a negative one
      // decodes nothing) and checks it against nothing.
      const int status = sgi_row(data, off, static_cast<int32_t>(len),
                                 row.data(), ch, z, bpc, w, n - 1);
      if (status == -1) return 2;
      if (status == 1) return 0;
    }
    std::memcpy(out + y * row_bytes, row.data(), row_bytes);
  }
  return 0;
}

// Status: 0 done, 1 the data runs out.
extern "C" int64_t wpt_packbits_rows(const uint8_t* data, int64_t n,
                                     int64_t pos, int64_t row_bytes,
                                     int64_t rows, uint8_t* out) {
  const int64_t total = row_bytes * rows;
  int64_t at = 0, x = 0;
  while (at < total) {
    if (pos >= n) return 1;
    const int b = data[pos];
    if (b == 0x80) {
      ++pos;
      continue;
    }
    int64_t k;
    if (b & 0x80) {
      if (pos + 2 > n) return 1;
      k = 257 - b;
      if (k > row_bytes - x) k = row_bytes - x;
      std::memset(out + at, data[pos + 1], k);
      pos += 2;
    } else {
      if (pos + b + 2 > n) return 1;
      k = b + 1;
      if (k > row_bytes - x) k = row_bytes - x;
      std::memcpy(out + at, data + pos + 1, k);
      pos += b + 2;
    }
    at += k;
    x += k;
    if (x == row_bytes) x = 0;
  }
  return 0;
}

// Status: 0 done, 1 the data runs out.
extern "C" int64_t wpt_sun_rle(const uint8_t* data, int64_t n, int64_t pos,
                               int64_t size, uint8_t* out) {
  int64_t at = 0;
  while (at < size) {
    if (pos >= n) return 1;
    const uint8_t b = data[pos];
    if (b != 0x80) {
      out[at++] = b;
      ++pos;
      continue;
    }
    if (pos + 1 >= n) return 1;
    const int64_t k = data[pos + 1];
    if (k == 0) {
      out[at++] = 0x80;
      pos += 2;
      continue;
    }
    if (pos + 2 >= n) return 1;
    int64_t run = k + 1;
    if (run > size - at) run = size - at;
    std::memset(out + at, data[pos + 2], run);
    at += run;
    pos += 3;
  }
  return 0;
}

// Rows of rowmap[y] bytes each from pos (a 0 a blank row of 0xFF), each a
// chain of runs (a 0 byte, a count and a value) and literal strings (a
// count, then as many bytes as the row holds of them), written on into
// out up to its size. Status: 0 done (*written the bytes the rows make,
// which may pass size), 1 a row runs past the data, 2 a run is cut short
// by the end of its row.
extern "C" int64_t wpt_msp_rle(const uint8_t* data, int64_t n, int64_t pos,
                               const int64_t* rowmap, int64_t rows,
                               int64_t blank, int64_t size, uint8_t* out,
                               int64_t* written) {
  int64_t at = 0;
  auto put = [&](const uint8_t* src, int64_t k, int value) {
    const int64_t room = at < size ? (k < size - at ? k : size - at) : 0;
    if (room > 0) {
      if (src) {
        std::memcpy(out + at, src, room);
      } else {
        std::memset(out + at, value, room);
      }
    }
    at += k;
  };
  for (int64_t y = 0; y < rows; ++y) {
    const int64_t len = rowmap[y];
    if (len == 0) {
      put(nullptr, blank, 0xFF);
      continue;
    }
    if (pos + len > n) return 1;
    const uint8_t* row = data + pos;
    int64_t i = 0;
    while (i < len) {
      const int t = row[i++];
      if (t == 0) {
        if (i + 2 > len) return 2;
        put(nullptr, row[i], row[i + 1]);
        i += 2;
      } else {
        const int64_t k = t < len - i ? t : len - i;
        put(row + i, k, 0);
        i += t;
      }
    }
    pos += len;
  }
  *written = at;
  return 0;
}

// One channel of size bytes from pos: a byte b >= 0x80 repeats the next
// byte b - 125 times, a byte b < 0x80 copies the next b + 1, until size
// bytes are counted or the data ends. Status: 0 done (*end where the
// channel ended), 1 the counts did not sum to size, 2 the data ended
// inside a packet (Pillow's buffer is then too short).
extern "C" int64_t wpt_icns_rle(const uint8_t* data, int64_t n, int64_t pos,
                                int64_t size, uint8_t* out, int64_t* end) {
  int64_t left = size, at = 0;
  bool short_data = false;
  while (left > 0) {
    if (pos >= n) break;
    const int b = data[pos++];
    int64_t k;
    if (b & 0x80) {
      k = b - 125;
      if (pos < n) {
        const int64_t room = k < size - at ? k : size - at;
        if (room > 0) std::memset(out + at, data[pos], room);
        at += k;
        ++pos;
      } else {
        short_data = true;
      }
    } else {
      k = b + 1;
      const int64_t got = k < n - pos ? k : n - pos;
      const int64_t room = got < size - at ? got : size - at;
      if (room > 0) std::memcpy(out + at, data + pos, room);
      if (got < k) short_data = true;
      at += got;
      pos += got;
    }
    left -= k;
  }
  *end = pos;
  if (left != 0) return 1;
  return short_data ? 2 : 0;
}

namespace {

inline int fli16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline int64_t fli32(const uint8_t* p) {
  return static_cast<int32_t>(static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
                              (static_cast<uint32_t>(p[2]) << 16) |
                              (static_cast<uint32_t>(p[3]) << 24));
}

}  // namespace

// One frame's bytes (n of them) into out (h x w indices, zero on entry).
// Status: 0 done, 1 bad data, 2 not enough data for the frame.
extern "C" int64_t wpt_fli(const uint8_t* buf, int64_t n, int64_t w, int64_t h,
                           uint8_t* out) {
  if (n < 4) return 2;
  const int64_t framesize = fli32(buf);
  if (n + (n % 2) < framesize) return 2;
  if (n < 8 || fli16(buf + 4) != 0xF1FA) return 1;
  const int chunks = fli16(buf + 6);
  int64_t ptr = 16, left = n - 16;
  for (int c = 0; c < chunks; ++c) {
    if (left < 10) return 1;
    int64_t data = ptr + 6;
    const int64_t end = ptr + left;
    const int kind = fli16(buf + ptr + 4);
    if (kind == 4 || kind == 11 || kind == 18) {
      // palette and stamp chunks: skipped
    } else if (kind == 7) {  // SS2
      const int lines = fli16(buf + data);
      data += 2;
      int64_t y = 0;
      int l = 0;
      for (; l < lines && y < h; ++l, ++y) {
        if (data + 2 > end) return 1;
        int packets = fli16(buf + data);
        data += 2;
        while (packets & 0x8000) {
          if (packets & 0x4000) {
            y += 65536 - packets;
            if (y >= h) return 1;
          } else {
            out[y * w + w - 1] = static_cast<uint8_t>(packets);
          }
          if (data + 2 > end) return 1;
          packets = fli16(buf + data);
          data += 2;
        }
        int64_t x = 0;
        int p = 0;
        for (; p < packets; ++p) {
          if (data + 2 > end) return 1;
          x += buf[data];
          if (buf[data + 1] >= 128) {
            if (data + 4 > end) return 1;
            const int64_t i = 256 - buf[data + 1];
            if (x + 2 * i > w) break;
            for (int64_t j = 0; j < i; ++j) {
              out[y * w + x++] = buf[data + 2];
              out[y * w + x++] = buf[data + 3];
            }
            data += 4;
          } else {
            const int64_t i = 2 * static_cast<int64_t>(buf[data + 1]);
            if (x + i > w) break;
            if (data + 2 + i > end) return 1;
            std::memcpy(out + y * w + x, buf + data + 2, static_cast<size_t>(i));
            data += 2 + i;
            x += i;
          }
        }
        if (p < packets) break;
      }
      if (l < lines) return 1;
    } else if (kind == 12) {  // LC
      int64_t y = fli16(buf + data);
      const int64_t ymax = y + fli16(buf + data + 2);
      data += 4;
      for (; y < ymax && y < h; ++y) {
        if (data + 1 > end) return 1;
        const int packets = buf[data++];
        int64_t x = 0, i = 0;
        int p = 0;
        for (; p < packets; ++p, x += i) {
          if (data + 2 > end) return 1;
          x += buf[data];
          if (buf[data + 1] & 0x80) {
            i = 256 - buf[data + 1];
            if (x + i > w) break;
            if (data + 3 > end) return 1;
            std::memset(out + y * w + x, buf[data + 2], static_cast<size_t>(i));
            data += 3;
          } else {
            i = buf[data + 1];
            if (x + i > w) break;
            if (data + 2 + i > end) return 1;
            std::memcpy(out + y * w + x, buf + data + 2, static_cast<size_t>(i));
            data += i + 2;
          }
        }
        if (p < packets) break;
      }
      if (y < ymax) return 1;
    } else if (kind == 13) {  // BLACK
      std::memset(out, 0, static_cast<size_t>(w * h));
    } else if (kind == 15) {  // BRUN
      for (int64_t y = 0; y < h; ++y) {
        data += 1;
        int64_t x = 0;
        while (x < w) {
          if (data + 2 > end) return 1;
          const int head = buf[data];
          int64_t i;
          if (head & 0x80) {
            i = 256 - head;
            if (x + i > w) break;
            if (data + i + 1 > end) return 1;
            std::memcpy(out + y * w + x, buf + data + 1, static_cast<size_t>(i));
            data += i + 1;
          } else {
            i = head;
            if (x + i > w) break;
            std::memset(out + y * w + x, buf[data + 1], static_cast<size_t>(i));
            data += 2;
          }
          x += i;
        }
        if (x != w) return 1;
      }
    } else if (kind == 16) {  // COPY
      if (data + w * h > end) return 2;
      std::memcpy(out, buf + data, static_cast<size_t>(w * h));
    } else {
      return 1;
    }
    const int64_t advance = fli32(buf + ptr);
    if (advance <= 0 || advance > left) return 1;
    ptr += advance;
    left -= advance;
  }
  return 0;
}

// bits (1-31) a pixel, least significant first, each row padded to bytes
// (whose leftover bits stay in the buffer and are OR-ed into the next
// row's first byte), rows bottom-up, from pos into out (h x w floats).
// Status: 0 done, 1 the data runs out.
extern "C" int64_t wpt_bit_decode(const uint8_t* data, int64_t n, int64_t pos,
                                  int64_t w, int64_t h, int32_t bits, float* out) {
  const uint64_t mask = (uint64_t(1) << bits) - 1;
  uint64_t buffer = 0;
  int64_t count = 0, x = 0, y = h - 1;
  for (int64_t at = pos; at < n; ++at) {
    const uint64_t byte = data[at];
    buffer |= byte << count;
    count += 8;
    while (count >= bits) {
      const uint64_t v = buffer & mask;
      if (count > 32) {
        buffer = byte >> (8 - (count - bits));
      } else {
        buffer >>= bits;
      }
      count -= bits;
      out[y * w + x] = static_cast<float>(v);
      if (++x >= w) {
        if (--y < 0) return 0;
        x = 0;
        count = 0;
      }
    }
  }
  return 1;
}

// Status: 0 done; 1 a row's data ran out or gave too many pixels (libtiff
// zeroes the rest of that row and fails the strip).
extern "C" int64_t wpt_thunder(const uint8_t* src, int64_t n, int64_t width,
                               int64_t rows, uint8_t* out) {
  static const int kTwo[4] = {0, 1, 0, -1};
  static const int kThree[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  const int64_t rowbytes = (width + 1) / 2;
  int64_t bp = 0;
  for (int64_t r = 0; r < rows; ++r) {
    uint8_t* row = out + r * rowbytes;
    uint8_t* op = row;
    unsigned lastpixel = 0;
    int64_t npixels = 0;
    auto setpixel = [&](unsigned v) {
      lastpixel = v & 0xF;
      if (npixels < width) {
        if (npixels++ & 1)
          *op++ |= uint8_t(lastpixel);
        else
          op[0] = uint8_t(lastpixel << 4);
      }
    };
    while (bp < n && npixels < width) {
      int c = src[bp++];
      int64_t k = c;
      switch (c & 0xC0) {
        case 0x00:
          if (npixels & 1) {
            op[0] |= uint8_t(lastpixel);
            lastpixel = *op++;
            npixels++;
            k--;
          } else {
            lastpixel |= lastpixel << 4;
          }
          npixels += k;
          if (npixels <= width)
            for (; k > 0; k -= 2) *op++ = uint8_t(lastpixel);
          if (k == -1) *--op &= 0xF0;
          lastpixel &= 0xF;
          break;
        case 0x40:
          for (int shift = 4; shift >= 0; shift -= 2) {
            int d = (c >> shift) & 3;
            if (d != 2) setpixel(unsigned(int(lastpixel) + kTwo[d]));
          }
          break;
        case 0x80:
          for (int shift = 3; shift >= 0; shift -= 3) {
            int d = (c >> shift) & 7;
            if (d != 4) setpixel(unsigned(int(lastpixel) + kThree[d]));
          }
          break;
        default:
          setpixel(unsigned(c));
      }
    }
    if (npixels != width) {
      std::memset(op, 0, size_t(row + rowbytes - op));
      return 1;
    }
  }
  return 0;
}
