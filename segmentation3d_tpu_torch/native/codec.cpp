// Native host codec of the PyTorch port: the JPEG Lossless scan decoder of
// io/jpeg_lossless.py and one-shot gzip through libdeflate for io/nifti.py
// and io/nrrd.py.
//
// The port's own copy of segmentation3d_tpu/native/codec.cpp's decoder and
// gzip entry points; the bit-packing entry points of that file serve the
// TPU host link and have no counterpart here. Loaded with ctypes
// (segmentation3d_tpu_torch/native/__init__.py, which builds it with g++ at
// first use). Plain C ABI, arrays passed as pointers, no Python.h.

#include <cstdint>
#include <cstddef>

extern "C" {

// ---------------------------------------------------------------------------
// JPEG Lossless (T.81 process 14) scan decoder — the per-sample hot loop of
// io/jpeg_lossless.py (see that module for the format notes). The
// Python side parses markers and builds the 16-bit Huffman peek LUT; this
// function decodes one frame's entropy-coded scan. Must stay in EXACT
// agreement with jpeg_lossless._decode_scan_py (parity-tested). The caller
// checks 2 <= precision <= 16, 1 <= predictor <= 7 and pt < precision.
// Returns 0 ok, 2 = invalid Huffman code.
int seg3d_jpegll_decode(const uint8_t* scan, size_t n,
                        const uint8_t* lut_sym, const uint8_t* lut_len,
                        int width, int height, int precision, int predictor,
                        int pt, int restart_interval, uint16_t* out) {
    uint32_t bitbuf = 0;
    int nbits = 0;
    size_t pos = 0;
    int def_px = 1 << (precision - pt - 1);
    int reset = 1;
    long until_rst = restart_interval ? restart_interval : -1;

    #define JLL_FILL() do { \
        while (nbits <= 24) { \
            uint8_t b; \
            if (pos >= n) { bitbuf <<= 8; nbits += 8; continue; } \
            b = scan[pos]; \
            if (b == 0xFF) { \
                uint8_t nxt = (pos + 1 < n) ? scan[pos + 1] : 0xD9; \
                if (nxt == 0x00) { pos += 2; } \
                else { bitbuf <<= 8; nbits += 8; continue; } \
            } else { pos += 1; } \
            bitbuf = (bitbuf << 8) | b; nbits += 8; \
        } \
    } while (0)

    for (int row = 0; row < height; ++row) {
        uint16_t* orow = out + (size_t)row * width;
        for (int col = 0; col < width; ++col) {
            if (until_rst == 0) {
                while (pos + 1 < n && !(scan[pos] == 0xFF &&
                                        scan[pos + 1] >= 0xD0 &&
                                        scan[pos + 1] <= 0xD7))
                    ++pos;
                if (pos + 1 < n) pos += 2;
                bitbuf = 0; nbits = 0; reset = 1;
                until_rst = restart_interval;
            }
            JLL_FILL();
            uint16_t peek = (uint16_t)((bitbuf >> (nbits - 16)) & 0xFFFF);
            int ssss = lut_sym[peek];
            int len = lut_len[peek];
            if (len == 0) return 2;
            nbits -= len;
            int32_t diff;
            if (ssss == 16) diff = 32768;
            else if (ssss == 0) diff = 0;
            else {
                JLL_FILL();
                uint32_t v = (bitbuf >> (nbits - ssss)) & ((1u << ssss) - 1);
                nbits -= ssss;
                diff = (v >= (1u << (ssss - 1))) ? (int32_t)v
                     : (int32_t)v - (1 << ssss) + 1;
            }
            int32_t px;
            if (reset) { px = def_px; reset = 0; }
            else if (row == 0) px = orow[col - 1];
            else if (col == 0) px = orow[-width];
            else {
                int32_t ra = orow[col - 1];
                int32_t rb = orow[col - width];
                int32_t rc = orow[col - width - 1];
                switch (predictor) {
                    case 1: px = ra; break;
                    case 2: px = rb; break;
                    case 3: px = rc; break;
                    case 4: px = ra + rb - rc; break;
                    case 5: px = ra + ((rb - rc) >> 1); break;
                    case 6: px = rb + ((ra - rc) >> 1); break;
                    default: px = (ra + rb) >> 1; break;
                }
            }
            orow[col] = (uint16_t)((px + diff) & 0xFFFF);
            if (until_rst > 0) --until_rst;
        }
    }
    #undef JLL_FILL
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// gzip via libdeflate: one-shot (de)compression of a whole buffer, which is
// the shape of both callers (the reader holds the full compressed blob, the
// writer the full payload). Guarded by __has_include and
// SEG3D_DISABLE_LIBDEFLATE so the codec still builds, without these three
// symbols, where libdeflate is missing; native/__init__.py then reports
// "zlib-only" and the callers use zlib.

#if defined(__has_include) && !defined(SEG3D_DISABLE_LIBDEFLATE)
#if __has_include(<libdeflate.h>)
#include <libdeflate.h>

extern "C" {

// Worst-case gzip-compressed size for n payload bytes at `level` (1-12).
size_t seg3d_gzip_bound(size_t n, int level) {
    struct libdeflate_compressor* c = libdeflate_alloc_compressor(level);
    if (!c) return 0;
    size_t b = libdeflate_gzip_compress_bound(c, n);
    libdeflate_free_compressor(c);
    return b;
}

// One-shot gzip compression; returns the compressed size, or 0 on failure
// (dst too small / alloc failure).
size_t seg3d_gzip_compress(const uint8_t* src, size_t n, int level,
                           uint8_t* dst, size_t cap) {
    struct libdeflate_compressor* c = libdeflate_alloc_compressor(level);
    if (!c) return 0;
    size_t out = libdeflate_gzip_compress(c, src, n, dst, cap);
    libdeflate_free_compressor(c);
    return out;
}

// One-shot decompression of ONE gzip member. Returns 0 on success,
// 1 if dst is too small (caller grows and retries), 2 on bad data.
// *in_used reports the member's compressed length (multi-member streams:
// the caller loops or falls back to zlib), *out_used the payload length.
int seg3d_gunzip_member(const uint8_t* src, size_t n, uint8_t* dst,
                        size_t cap, size_t* in_used, size_t* out_used) {
    struct libdeflate_decompressor* d = libdeflate_alloc_decompressor();
    if (!d) return 2;
    enum libdeflate_result r = libdeflate_gzip_decompress_ex(
        d, src, n, dst, cap, in_used, out_used);
    libdeflate_free_decompressor(d);
    if (r == LIBDEFLATE_SUCCESS) return 0;
    if (r == LIBDEFLATE_INSUFFICIENT_SPACE) return 1;
    return 2;
}

}  // extern "C"

#endif  // __has_include(<libdeflate.h>)
#endif  // defined(__has_include) && !defined(SEG3D_DISABLE_LIBDEFLATE)
