// Native host layer of gol_tpu_torch: the port's own copy of the JAX
// package's `csrc/golnative.cpp`, with the same C interface.
//
// Role parity with the reference's single native dependency — libSDL2
// reached through cgo (`Local/sdl/window.go:4`) — plus the host-side data
// plane the Go version does in its io goroutine (`Local/gol/io.go:42-121`):
//
//   * PGM P5 codec: single-pass read/validate/write; the numpy path needs
//     several array passes, which matters at 65536² (4.3 GB).
//   * Bit pack/unpack: {0,255} pixels ⇄ 32 cells/uint32, LSB-first —
//     the bit layout of gol_tpu_torch/ops/bitpack.py's packed words.
//   * Popcount: alive count of a packed board.
//   * Half-block frame renderer: board → UTF-8 ANSI frame (two board rows
//     per character line), the terminal stand-in for the SDL texture.
//   * uint64 bit-parallel torus stepper: a host CPU oracle for
//     cross-checks (the reference's worker compute role,
//     `SubServer/distributor.go:119-208`, as carry-save adders instead of
//     per-cell branches).
//
// C ABI only (consumed via ctypes from gol_tpu_torch/native.py, which
// builds this file with g++ at first use). All functions return 0 on
// success or a negative errno-style code.

#include <cctype>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kMaxval = 255;

// Read at most `cap` leading bytes — the header tokenizer never needs the
// payload, and slurping a 65536² file (4.3 GB) just to parse a ~20-byte
// header would defeat the codec's single-pass design.
int read_prefix(const char* path, size_t cap, std::string* out) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  out->resize(cap);
  size_t got = std::fread(&(*out)[0], 1, cap, f);
  if (got < cap && std::ferror(f)) { std::fclose(f); return -3; }
  std::fclose(f);
  out->resize(got);
  return 0;
}

// strtol with whole-token validation: "12abc" is a header error, not 12
// (matches the Python tokenizer's int() strictness), and an out-of-range
// token is an error rather than a silent clamp to LONG_MAX. The end must
// be the token's own end: a NUL byte inside the token ("2\0") would stop
// strtol early and pass a '\0' test, accepting a header int() refuses.
bool parse_dim(const std::string& tok, long* out) {
  if (tok.empty()) return false;
  char* end = nullptr;
  errno = 0;
  long v = std::strtol(tok.c_str(), &end, 10);
  if (errno == ERANGE || end != tok.c_str() + tok.size()) return false;
  *out = v;
  return true;
}

// Whitespace-delimited header token, '#' comments skipped.
bool next_token(const std::string& buf, size_t* pos, std::string* tok) {
  size_t n = buf.size(), p = *pos;
  while (p < n) {
    if (buf[p] == '#') { while (p < n && buf[p] != '\n') ++p; }
    else if (std::isspace(static_cast<unsigned char>(buf[p]))) ++p;
    else break;
  }
  size_t start = p;
  while (p < n && !std::isspace(static_cast<unsigned char>(buf[p]))) ++p;
  *pos = p;
  if (start == p) return false;
  tok->assign(buf, start, p - start);
  return true;
}

}  // namespace

extern "C" {

// Parse the P5 header: fills (*w, *h) and *payload_off (offset of the
// first payload byte). Returns 0, or <0 on malformed/mismatched input.
int gol_pgm_read_header(const char* path, int64_t* w, int64_t* h,
                        int64_t* payload_off) {
  // 64 KB bounds even comment-heavy headers; the payload is never needed.
  std::string buf;
  if (int rc = read_prefix(path, 64 * 1024, &buf)) return rc;
  size_t pos = 0;
  std::string tok;
  if (!next_token(buf, &pos, &tok) || tok != "P5") return -10;
  std::string ws, hs, ms;
  if (!next_token(buf, &pos, &ws) || !next_token(buf, &pos, &hs) ||
      !next_token(buf, &pos, &ms))
    return -11;
  long wv, hv, mv;
  if (!parse_dim(ws, &wv) || !parse_dim(hs, &hv) || !parse_dim(ms, &mv))
    return -11;
  if (wv <= 0 || hv <= 0) return -12;
  if (mv != kMaxval) return -13;  // reference contract: maxval MUST be 255
  *w = wv;
  *h = hv;
  *payload_off = static_cast<int64_t>(pos) + 1;  // one ws byte ends header
  return 0;
}

// Read the payload directly into `out` (caller-sized w*h), validating
// {0,255} — a seek + one fread, no intermediate buffer (at 65536² the
// payload is 4.3 GB; slurping it twice would dwarf the Python fallback).
int gol_pgm_read_payload(const char* path, int64_t payload_off,
                         uint8_t* out, int64_t count) {
  if (payload_off < 0 || count < 0) return -20;
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  if (std::fseek(f, static_cast<long>(payload_off), SEEK_SET) != 0) {
    std::fclose(f);
    return -20;
  }
  size_t got = std::fread(out, 1, static_cast<size_t>(count), f);
  std::fclose(f);
  if (got != static_cast<size_t>(count)) return -20;
  for (int64_t i = 0; i < count; ++i) {
    uint8_t v = out[i];
    if (v != 0 && v != kMaxval) return -21;
  }
  return 0;
}

int gol_pgm_write(const char* path, const uint8_t* board, int64_t w,
                  int64_t h) {
  std::FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  std::fprintf(f, "P5\n%lld %lld\n%d\n", static_cast<long long>(w),
               static_cast<long long>(h), kMaxval);
  size_t n = static_cast<size_t>(w) * static_cast<size_t>(h);
  size_t put = std::fwrite(board, 1, n, f);
  int rc = std::fclose(f);
  return (put == n && rc == 0) ? 0 : -4;
}

// {0,255} (or {0,1}) pixels → packed words, 32 cells/word LSB-first.
// w must be a multiple of 32 (caller-checked).
void gol_pack_bits(const uint8_t* pixels, uint32_t* words, int64_t h,
                   int64_t w) {
  int64_t wp = w / 32;
  for (int64_t r = 0; r < h; ++r) {
    const uint8_t* row = pixels + r * w;
    uint32_t* wrow = words + r * wp;
    for (int64_t c = 0; c < wp; ++c) {
      uint32_t v = 0;
      for (int b = 0; b < 32; ++b)
        v |= static_cast<uint32_t>(row[c * 32 + b] != 0) << b;
      wrow[c] = v;
    }
  }
}

// Packed words → {0,255} pixels.
void gol_unpack_bits(const uint32_t* words, uint8_t* pixels, int64_t h,
                     int64_t w) {
  int64_t wp = w / 32;
  for (int64_t r = 0; r < h; ++r) {
    const uint32_t* wrow = words + r * wp;
    uint8_t* row = pixels + r * w;
    for (int64_t c = 0; c < wp; ++c) {
      uint32_t v = wrow[c];
      for (int b = 0; b < 32; ++b)
        row[c * 32 + b] = (v >> b) & 1 ? kMaxval : 0;
    }
  }
}

int64_t gol_popcount_words(const uint32_t* words, int64_t n) {
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i)
    total += __builtin_popcount(words[i]);
  return total;
}

// Render a {0,255} board as a UTF-8 half-block frame: two board rows per
// character line (' ', '▀', '▄', '█'), '\n'-terminated lines. Writes at
// most `cap` bytes into `out`; returns bytes written, or -1 if `cap` is
// too small (worst case 3*w + 1 bytes per line, ceil(h/2) lines).
int64_t gol_render_halfblocks(const uint8_t* pixels, int64_t h, int64_t w,
                              char* out, int64_t cap) {
  static const char* kGlyph[4] = {" ", "\xE2\x96\x80", "\xE2\x96\x84",
                                  "\xE2\x96\x88"};
  static const int kLen[4] = {1, 3, 3, 3};
  int64_t pos = 0;
  for (int64_t r = 0; r < h; r += 2) {
    for (int64_t c = 0; c < w; ++c) {
      int top = pixels[r * w + c] != 0;
      int bot = (r + 1 < h) ? pixels[(r + 1) * w + c] != 0 : 0;
      int g = top | (bot << 1);
      if (pos + kLen[g] + 1 > cap) return -1;
      std::memcpy(out + pos, kGlyph[g], kLen[g]);
      pos += kLen[g];
    }
    out[pos++] = '\n';
  }
  return pos;
}

// One Conway turn on a torus, 64 cells/word LSB-first; wq words per row.
// Carry-save adder network with self-inclusive counts — the same math the
// stepping kernels run on the card (csrc/stencil.cu), word-level on the
// host CPU.
void gol_step_torus_u64(const uint64_t* in, uint64_t* out, int64_t h,
                        int64_t wq) {
  std::vector<uint64_t> hs0(static_cast<size_t>(h) * wq);
  std::vector<uint64_t> hs1(static_cast<size_t>(h) * wq);
  // Horizontal (west + self + east) per cell, torus across words.
  for (int64_t r = 0; r < h; ++r) {
    const uint64_t* row = in + r * wq;
    for (int64_t c = 0; c < wq; ++c) {
      uint64_t self = row[c];
      uint64_t left = row[(c - 1 + wq) % wq];
      uint64_t right = row[(c + 1) % wq];
      uint64_t west = (self << 1) | (left >> 63);
      uint64_t east = (self >> 1) | (right << 63);
      uint64_t xy = west ^ east;
      hs0[r * wq + c] = xy ^ self;
      hs1[r * wq + c] = (west & east) | (self & xy);
    }
  }
  // Vertical full-adders over the three row sums; rule on n9.
  for (int64_t r = 0; r < h; ++r) {
    int64_t up = (r - 1 + h) % h, dn = (r + 1) % h;
    for (int64_t c = 0; c < wq; ++c) {
      uint64_t a0 = hs0[up * wq + c], b0 = hs0[r * wq + c],
               c0 = hs0[dn * wq + c];
      uint64_t a1 = hs1[up * wq + c], b1 = hs1[r * wq + c],
               c1 = hs1[dn * wq + c];
      uint64_t xy0 = a0 ^ b0;
      uint64_t u0 = xy0 ^ c0;
      uint64_t u1 = (a0 & b0) | (c0 & xy0);
      uint64_t xy1 = a1 ^ b1;
      uint64_t v0 = xy1 ^ c1;
      uint64_t v1 = (a1 & b1) | (c1 & xy1);
      uint64_t n1 = u1 ^ v0;
      uint64_t c2 = u1 & v0;
      uint64_t n2 = v1 ^ c2;
      uint64_t n3 = v1 & c2;
      uint64_t self = in[r * wq + c];
      // alive' = (n9 == 3) | (alive & n9 == 4)
      out[r * wq + c] =
          ~n3 & ((~n2 & n1 & u0) | (self & n2 & ~n1 & ~u0));
    }
  }
}

}  // extern "C"
