// codec: the host-side image and record codec of the RLDS training-data path.
//
// Released Open-X RLDS data stores every camera frame as an encoded JPEG (or
// PNG) inside TFRecord shards. This file decodes and encodes them without
// TensorFlow, libjpeg, PIL or cv2, and runs the frame transforms' pixel loops:
//
//   jpeg_header / jpeg_decode   baseline (SOF0/SOF1) Huffman JPEG, 8-bit, one or
//                               three components, sampling factors up to 2x2,
//                               restart intervals; libjpeg's IFAST IDCT
//                               (jidctfst.c), fancy upsampling (jdsample.c) and
//                               integer YCbCr->RGB (jdcolor.c): the output of
//                               tf.io.decode_image with its default arguments
//   jpeg_encode                 baseline JPEG as tf.io.encode_jpeg writes it:
//                               libjpeg's scaled Annex K tables, the standard
//                               Huffman tables, 4:2:0 with the alternating
//                               bias, the ISLOW forward DCT
//   png_unfilter                the five PNG row filters on inflated 8-bit
//                               gray / gray+alpha / RGB / RGBA rows -> RGB
//   crc32c                      Castagnoli CRC (TFRecord framing)
//   resize_lanczos3_u8          tf.image.resize(method="lanczos3"), with or
//                               without antialias (scale_and_translate),
//                               truncated (the data path) or rounded (the
//                               Octo adapter) to uint8
//   resize_lanczos4_cv_u8       cv2.resize(INTER_LANCZOS4) on 8-bit frames, the
//                               serving adapters' resize
//   crop_resize_jitter_u8       the train path's fused random-resized crop
//                               (bilinear crop_and_resize) and colour jitter
//                               (brightness, contrast, saturation, hue)
//
// C linkage for ctypes; every function is reentrant (no global state but a
// thread-local error message) so a thread pool decodes in parallel while
// ctypes releases the GIL. Errors return a negative code; codec_error() names
// the cause.

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

thread_local char g_err[256];

int fail(const char* fmt, ...) {
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(g_err, sizeof(g_err), fmt, ap);
    va_end(ap);
    return -1;
}

// zigzag -> natural order, with 16 extra entries so a corrupt run cannot
// index past the block (libjpeg's jpeg_natural_order)
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------------------
// JPEG decoder
// ---------------------------------------------------------------------------

struct Huff {
    bool present = false;
    uint8_t vals[256];
    int mincode[17], maxcode[18], valptr[17];
    uint8_t look_len[512], look_val[512];  // 9-bit fast path
};

bool build_huff(Huff& h, const uint8_t* bits, const uint8_t* vals, int nvals) {
    int total = 0;
    for (int l = 1; l <= 16; ++l) total += bits[l - 1];
    if (total > 256 || total > nvals) return false;
    memcpy(h.vals, vals, total);
    int code = 0, k = 0;
    memset(h.look_len, 0, sizeof(h.look_len));
    for (int l = 1; l <= 16; ++l) {
        h.valptr[l] = k;
        h.mincode[l] = code;
        for (int i = 0; i < bits[l - 1]; ++i, ++code, ++k) {
            if (l <= 9) {
                int base = code << (9 - l);
                for (int j = 0; j < (1 << (9 - l)); ++j) {
                    h.look_len[base + j] = (uint8_t)l;
                    h.look_val[base + j] = h.vals[k];
                }
            }
        }
        h.maxcode[l] = bits[l - 1] ? code - 1 : -1;
        if (code > (1 << l)) return false;
        code <<= 1;
    }
    h.maxcode[17] = 0x7fffffff;
    h.present = true;
    return true;
}

struct BitReader {
    const uint8_t* p;
    size_t n, pos;
    uint64_t acc = 0;
    int cnt = 0;
    bool marker = false;  // stopped at a marker: feed zeros, as libjpeg does

    void fill() {
        while (cnt <= 56) {
            uint32_t b = 0;
            if (!marker && pos < n) {
                b = p[pos];
                if (b == 0xFF) {
                    uint8_t nx = pos + 1 < n ? p[pos + 1] : 0xD9;
                    if (nx == 0x00) {
                        pos += 2;
                    } else {
                        marker = true;
                        b = 0;
                    }
                } else {
                    ++pos;
                }
            }
            acc |= (uint64_t)b << (56 - cnt);
            cnt += 8;
        }
    }
    int bits(int s) {
        if (s == 0) return 0;
        if (cnt < s) fill();
        int v = (int)(acc >> (64 - s));
        acc <<= s;
        cnt -= s;
        return v;
    }
    int decode(const Huff& h) {
        if (cnt < 16) fill();
        int look = (int)(acc >> (64 - 9));
        int l = h.look_len[look];
        if (l) {
            acc <<= l;
            cnt -= l;
            return h.look_val[look];
        }
        for (l = 10; l <= 16; ++l) {
            int code = (int)(acc >> (64 - l));
            if (code <= h.maxcode[l]) {
                acc <<= l;
                cnt -= l;
                return h.vals[h.valptr[l] + code - h.mincode[l]];
            }
        }
        acc <<= 16;  // corrupt data: libjpeg warns and returns 0
        cnt -= 16;
        return 0;
    }
    // after a restart interval: drop the padding bits, step over RSTn
    void restart() {
        acc = 0;
        cnt = 0;
        marker = false;
        while (pos + 1 < n && !(p[pos] == 0xFF && p[pos + 1] >= 0xD0 && p[pos + 1] <= 0xD7)) ++pos;
        if (pos + 1 < n) pos += 2;
    }
};

inline int extend(int v, int s) { return (s && v < (1 << (s - 1))) ? v - (1 << s) + 1 : v; }

const int kAanScales[64] = {
    16384, 22725, 21407, 19266, 16384, 12873, 8867,  4520,  22725, 31521, 29692, 26722, 22725,
    17855, 12299, 6270,  21407, 29692, 27969, 25172, 21407, 16819, 11585, 5906,  19266, 26722,
    25172, 22654, 19266, 15137, 10426, 5315,  16384, 22725, 21407, 19266, 16384, 12873, 8867,
    4520,  12873, 17855, 16819, 15137, 12873, 10114, 6967,  3552,  8867,  12299, 11585, 10426,
    8867,  6967,  4799,  2446,  4520,  6270,  5906,  5315,  4520,  3552,  2446,  1247};

// libjpeg's post-IDCT range limit: x & 1023 indexes a table that clamps
// [-512, 511] + 128 to [0, 255] (jdmaster.c prepare_range_limit_table)
struct RangeLimit {
    uint8_t t[1024];
    RangeLimit() {
        for (int i = 0; i < 1024; ++i) {
            int v = i < 512 ? i : i - 1024;
            t[i] = (uint8_t)std::min(255, std::max(0, v + 128));
        }
    }
};
const RangeLimit kRange;

// jidctfst.c (8-bit): CONST_BITS 8, PASS1_BITS 2, truncating MULTIPLY and
// IDESCALE (USE_ACCURATE_ROUNDING off)
inline int fmul(int v, int c) { return (v * c) >> 8; }

void idct_ifast(const int16_t* coef, const int* q, uint8_t* out, int stride) {
    int ws[64];
    for (int c = 0; c < 8; ++c) {
        const int16_t* in = coef + c;
        const int* qt = q + c;
        int* w = ws + c;
        if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
            int dc = in[0] * qt[0];
            for (int r = 0; r < 8; ++r) w[8 * r] = dc;
            continue;
        }
        int tmp0 = in[0] * qt[0], tmp1 = in[16] * qt[16], tmp2 = in[32] * qt[32], tmp3 = in[48] * qt[48];
        int tmp10 = tmp0 + tmp2, tmp11 = tmp0 - tmp2;
        int tmp13 = tmp1 + tmp3, tmp12 = fmul(tmp1 - tmp3, 362) - tmp13;
        tmp0 = tmp10 + tmp13;
        tmp3 = tmp10 - tmp13;
        tmp1 = tmp11 + tmp12;
        tmp2 = tmp11 - tmp12;
        int tmp4 = in[8] * qt[8], tmp5 = in[24] * qt[24], tmp6 = in[40] * qt[40], tmp7 = in[56] * qt[56];
        int z13 = tmp6 + tmp5, z10 = tmp6 - tmp5, z11 = tmp4 + tmp7, z12 = tmp4 - tmp7;
        tmp7 = z11 + z13;
        tmp11 = fmul(z11 - z13, 362);
        int z5 = fmul(z10 + z12, 473);
        tmp10 = fmul(z12, 277) - z5;
        tmp12 = fmul(z10, -669) + z5;
        tmp6 = tmp12 - tmp7;
        tmp5 = tmp11 - tmp6;
        tmp4 = tmp10 + tmp5;
        w[0] = tmp0 + tmp7;
        w[56] = tmp0 - tmp7;
        w[8] = tmp1 + tmp6;
        w[48] = tmp1 - tmp6;
        w[16] = tmp2 + tmp5;
        w[40] = tmp2 - tmp5;
        w[32] = tmp3 + tmp4;
        w[24] = tmp3 - tmp4;
    }
    for (int r = 0; r < 8; ++r) {
        const int* w = ws + 8 * r;
        uint8_t* o = out + (size_t)r * stride;
        if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
            uint8_t dc = kRange.t[(w[0] >> 5) & 1023];
            for (int c = 0; c < 8; ++c) o[c] = dc;
            continue;
        }
        int tmp10 = w[0] + w[4], tmp11 = w[0] - w[4];
        int tmp13 = w[2] + w[6], tmp12 = fmul(w[2] - w[6], 362) - tmp13;
        int tmp0 = tmp10 + tmp13, tmp3 = tmp10 - tmp13, tmp1 = tmp11 + tmp12, tmp2 = tmp11 - tmp12;
        int z13 = w[5] + w[3], z10 = w[5] - w[3], z11 = w[1] + w[7], z12 = w[1] - w[7];
        int tmp7 = z11 + z13;
        tmp11 = fmul(z11 - z13, 362);
        int z5 = fmul(z10 + z12, 473);
        tmp10 = fmul(z12, 277) - z5;
        tmp12 = fmul(z10, -669) + z5;
        int tmp6 = tmp12 - tmp7, tmp5 = tmp11 - tmp6, tmp4 = tmp10 + tmp5;
        o[0] = kRange.t[((tmp0 + tmp7) >> 5) & 1023];
        o[7] = kRange.t[((tmp0 - tmp7) >> 5) & 1023];
        o[1] = kRange.t[((tmp1 + tmp6) >> 5) & 1023];
        o[6] = kRange.t[((tmp1 - tmp6) >> 5) & 1023];
        o[2] = kRange.t[((tmp2 + tmp5) >> 5) & 1023];
        o[5] = kRange.t[((tmp2 - tmp5) >> 5) & 1023];
        o[4] = kRange.t[((tmp3 + tmp4) >> 5) & 1023];
        o[3] = kRange.t[((tmp3 - tmp4) >> 5) & 1023];
    }
}

struct Component {
    int id, h, v, tq;
    int td = 0, ta = 0;
    int ds_w, ds_h;   // downsampled size (jdinput.c)
    int pw, ph;       // plane size, whole MCUs
    int dc_pred = 0;
    std::vector<uint8_t> plane;
};

struct Jpeg {
    const uint8_t* p;
    size_t n;
    int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
    int restart = 0;
    int adobe_transform = -1;
    bool have_frame = false;
    uint16_t qt[4][64];
    bool qt_present[4] = {false, false, false, false};
    Huff dc[4], ac[4];
    Component comp[3];
};

const char* sof_name(int m) {
    switch (m) {
        case 0xC2: return "progressive JPEG (SOF2)";
        case 0xC3: return "lossless JPEG (SOF3)";
        case 0xC5: case 0xC6: case 0xC7: return "hierarchical JPEG (SOF5-7)";
        case 0xC9: return "arithmetic-coded JPEG (SOF9)";
        case 0xCA: return "progressive arithmetic-coded JPEG (SOF10)";
        case 0xCB: return "lossless arithmetic-coded JPEG (SOF11)";
        default: return "arithmetic-coded hierarchical JPEG (SOF13-15)";
    }
}

int u16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

int parse_frame(Jpeg& j, const uint8_t* s, int len) {
    if (len < 6) return fail("JPEG SOF segment too short");
    if (s[0] != 8) return fail("%d-bit JPEG (SOF precision %d) is not supported: only 8-bit samples", s[0], s[0]);
    j.height = u16(s + 1);
    j.width = u16(s + 3);
    j.ncomp = s[5];
    if (j.width <= 0 || j.height <= 0) return fail("JPEG with a zero dimension (%dx%d)", j.width, j.height);
    if (j.ncomp != 1 && j.ncomp != 3) return fail("JPEG with %d components: only 1 (gray) or 3 are supported", j.ncomp);
    if (len < 6 + 3 * j.ncomp) return fail("JPEG SOF segment too short");
    j.hmax = j.vmax = 1;
    for (int i = 0; i < j.ncomp; ++i) {
        Component& c = j.comp[i];
        c.id = s[6 + 3 * i];
        c.h = s[7 + 3 * i] >> 4;
        c.v = s[7 + 3 * i] & 15;
        c.tq = s[8 + 3 * i];
        if (c.h < 1 || c.h > 2 || c.v < 1 || c.v > 2 || c.tq > 3)
            return fail("JPEG sampling factors %dx%d (or table %d) not supported: up to 2x2", c.h, c.v, c.tq);
        j.hmax = std::max(j.hmax, c.h);
        j.vmax = std::max(j.vmax, c.v);
    }
    j.mcux = (j.width + 8 * j.hmax - 1) / (8 * j.hmax);
    j.mcuy = (j.height + 8 * j.vmax - 1) / (8 * j.vmax);
    for (int i = 0; i < j.ncomp; ++i) {
        Component& c = j.comp[i];
        c.ds_w = (j.width * c.h + j.hmax - 1) / j.hmax;
        c.ds_h = (j.height * c.v + j.vmax - 1) / j.vmax;
        c.pw = j.mcux * c.h * 8;
        c.ph = j.mcuy * c.v * 8;
    }
    j.have_frame = true;
    return 0;
}

// walk the markers up to the first SOS (header only) or through every scan
int jpeg_parse(Jpeg& j, bool decode);

int decode_scan(Jpeg& j, const uint8_t* s, int len, size_t& pos) {
    if (!j.have_frame) return fail("JPEG SOS before SOF");
    int ns = s[0];
    if (ns < 1 || ns > j.ncomp || len < 4 + 2 * ns) return fail("bad JPEG SOS segment");
    Component* sc[3];
    int qtab[3][64];
    for (int i = 0; i < ns; ++i) {
        int id = s[1 + 2 * i], k = -1;
        for (int c = 0; c < j.ncomp; ++c)
            if (j.comp[c].id == id) k = c;
        if (k < 0) return fail("JPEG SOS names unknown component %d", id);
        sc[i] = &j.comp[k];
        sc[i]->td = s[2 + 2 * i] >> 4;
        sc[i]->ta = s[2 + 2 * i] & 15;
        if (sc[i]->td > 3 || sc[i]->ta > 3 || !j.dc[sc[i]->td].present || !j.ac[sc[i]->ta].present)
            return fail("JPEG scan uses an undefined Huffman table");
        if (!j.qt_present[sc[i]->tq]) return fail("JPEG component uses an undefined quantization table");
        for (int t = 0; t < 64; ++t)  // jddctmgr.c: IFAST multipliers, 12-bit descale with rounding
            qtab[i][t] = (j.qt[sc[i]->tq][t] * kAanScales[t] + (1 << 11)) >> 12;
        if (sc[i]->plane.empty()) sc[i]->plane.assign((size_t)sc[i]->pw * sc[i]->ph, 0);
        sc[i]->dc_pred = 0;
    }
    int ss = s[1 + 2 * ns], se = s[2 + 2 * ns], ahal = s[3 + 2 * ns];
    if (ss != 0 || se != 63 || ahal != 0) return fail("JPEG scan with spectral selection: progressive files are not supported");

    BitReader br{j.p, j.n, pos};
    int16_t blk[64];
    auto block = [&](int i, int x0, int y0) {
        Component& c = *sc[i];
        memset(blk, 0, sizeof(blk));
        int t = br.decode(j.dc[c.td]);
        int diff = t ? extend(br.bits(t), t) : 0;
        c.dc_pred += diff;
        blk[0] = (int16_t)c.dc_pred;
        const Huff& ah = j.ac[c.ta];
        for (int k = 1; k < 64;) {
            int rs = br.decode(ah);
            int r = rs >> 4, sz = rs & 15;
            if (sz) {
                k += r;
                blk[kNatural[k]] = (int16_t)extend(br.bits(sz), sz);
                ++k;
            } else {
                if (r != 15) break;
                k += 16;
            }
        }
        idct_ifast(blk, qtab[i], c.plane.data() + (size_t)y0 * c.pw + x0, c.pw);
    };
    int bw = 0, bh = 0;
    if (ns == 1) {  // non-interleaved: one block per MCU over the component's own block grid
        bw = (sc[0]->ds_w + 7) / 8;
        bh = (sc[0]->ds_h + 7) / 8;
    }
    long total = ns == 1 ? (long)bw * bh : (long)j.mcux * j.mcuy;
    for (long m = 0; m < total; ++m) {
        if (j.restart && m > 0 && m % j.restart == 0) {
            br.restart();
            for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
        }
        if (ns == 1) {
            block(0, (int)(m % bw) * 8, (int)(m / bw) * 8);
        } else {
            int mx = (int)(m % j.mcux), my = (int)(m / j.mcux);
            for (int i = 0; i < ns; ++i)
                for (int by = 0; by < sc[i]->v; ++by)
                    for (int bx = 0; bx < sc[i]->h; ++bx)
                        block(i, (mx * sc[i]->h + bx) * 8, (my * sc[i]->v + by) * 8);
        }
    }
    // resume at the marker that ends the entropy-coded data
    size_t q = br.pos;
    while (q + 1 < j.n && !(j.p[q] == 0xFF && j.p[q + 1] != 0x00 && !(j.p[q + 1] >= 0xD0 && j.p[q + 1] <= 0xD7))) ++q;
    pos = q;
    return 0;
}

int jpeg_parse(Jpeg& j, bool decode) {
    size_t pos = 0;
    if (j.n < 4 || j.p[0] != 0xFF || j.p[1] != 0xD8) return fail("not a JPEG (no SOI marker)");
    pos = 2;
    bool scanned = false;
    while (pos + 1 < j.n) {
        if (j.p[pos] != 0xFF) {
            ++pos;  // garbage between segments: libjpeg skips it with a warning
            continue;
        }
        int m = j.p[pos + 1];
        pos += 2;
        if (m == 0xFF || m == 0x01 || (m >= 0xD0 && m <= 0xD7)) {
            if (m == 0xFF) --pos;
            continue;
        }
        if (m == 0xD9) break;  // EOI
        if (pos + 2 > j.n) return fail("truncated JPEG segment");
        int len = u16(j.p + pos);
        if (len < 2 || pos + len > j.n) return fail("truncated JPEG segment (marker 0x%02X)", m);
        const uint8_t* s = j.p + pos + 2;
        int sl = len - 2;
        pos += len;
        if (m == 0xC0 || m == 0xC1) {
            if (parse_frame(j, s, sl)) return -1;
            if (!decode) return 0;
        } else if ((m >= 0xC2 && m <= 0xCB && m != 0xC4 && m != 0xC8) || (m >= 0xCD && m <= 0xCF)) {
            return fail("%s (marker 0x%02X) is not supported: only baseline Huffman JPEG", sof_name(m), m);
        } else if (m == 0xCC) {
            return fail("arithmetic-coded JPEG (DAC marker 0xCC) is not supported");
        } else if (m == 0xC4) {
            int o = 0;
            while (o + 17 <= sl) {
                int tc = s[o] >> 4, th = s[o] & 15;
                const uint8_t* bits = s + o + 1;
                int cnt = 0;
                for (int l = 0; l < 16; ++l) cnt += bits[l];
                if (th > 3 || tc > 1 || o + 17 + cnt > sl) return fail("bad JPEG DHT segment");
                if (!build_huff(tc ? j.ac[th] : j.dc[th], bits, s + o + 17, cnt)) return fail("bad JPEG Huffman table");
                o += 17 + cnt;
            }
        } else if (m == 0xDB) {
            int o = 0;
            while (o < sl) {
                int pq = s[o] >> 4, tq = s[o] & 15;
                if (tq > 3 || o + 1 + 64 * (pq + 1) > sl) return fail("bad JPEG DQT segment");
                for (int i = 0; i < 64; ++i)
                    j.qt[tq][kNatural[i]] = pq ? (uint16_t)u16(s + o + 1 + 2 * i) : s[o + 1 + i];
                j.qt_present[tq] = true;
                o += 1 + 64 * (pq + 1);
            }
        } else if (m == 0xDD) {
            if (sl < 2) return fail("bad JPEG DRI segment");
            j.restart = u16(s);
        } else if (m == 0xEE) {  // Adobe: transform 0 means the 3 components are RGB
            if (sl >= 12 && memcmp(s, "Adobe", 5) == 0) j.adobe_transform = s[11];
        } else if (m == 0xDA) {
            if (!decode) return fail("JPEG SOS before SOF");
            if (decode_scan(j, s, sl, pos)) return -1;
            scanned = true;
        }
    }
    if (!j.have_frame) return fail("JPEG without a frame header (no SOF0/SOF1 marker)");
    if (decode && !scanned) return fail("JPEG without image data (no SOS marker)");
    for (int i = 0; i < j.ncomp && decode; ++i)
        if (j.comp[i].plane.empty()) return fail("JPEG component %d has no scan", j.comp[i].id);
    return 0;
}

// jdsample.c: one component's row `y` of the output at full resolution
void upsample_row(const Component& c, int hmax, int vmax, int y, uint8_t* out, int out_w) {
    const int fh = hmax / c.h, fv = vmax / c.v;
    const int W = c.ds_w, H = c.ds_h;
    const uint8_t* pl = c.plane.data();
    auto row = [&](int r) { return pl + (size_t)std::min(std::max(r, 0), H - 1) * c.pw; };
    if (fh == 1 && fv == 1) {
        memcpy(out, row(y), out_w);
        return;
    }
    if (fh == 1 && fv == 2) {  // h1v2 fancy: triangle filter in y only
        int inrow = y >> 1, v = y & 1;
        const uint8_t* r0 = row(inrow);
        const uint8_t* r1 = row(v ? inrow + 1 : inrow - 1);
        int bias = v ? 2 : 1;
        for (int x = 0; x < out_w; ++x) out[x] = (uint8_t)((r0[x] * 3 + r1[x] + bias) >> 2);
        return;
    }
    std::vector<uint8_t> tmp(2 * (size_t)W + 2);
    uint8_t* o = tmp.data();
    if (fv == 1) {  // h2v1
        const uint8_t* in = row(y);
        if (W <= 2) {  // jdsample.c falls back to replication for narrow rows
            for (int x = 0; x < W; ++x) o[2 * x] = o[2 * x + 1] = in[x];
        } else {
            o[0] = in[0];
            o[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
            for (int x = 1; x < W - 1; ++x) {
                int v3 = in[x] * 3;
                o[2 * x] = (uint8_t)((v3 + in[x - 1] + 1) >> 2);
                o[2 * x + 1] = (uint8_t)((v3 + in[x + 1] + 2) >> 2);
            }
            o[2 * W - 2] = (uint8_t)((in[W - 1] * 3 + in[W - 2] + 1) >> 2);
            o[2 * W - 1] = in[W - 1];
        }
    } else {  // h2v2
        int inrow = y >> 1, v = y & 1;
        const uint8_t* r0 = row(inrow);
        if (W <= 2) {
            for (int x = 0; x < W; ++x) o[2 * x] = o[2 * x + 1] = r0[x];
        } else {
            const uint8_t* r1 = row(v ? inrow + 1 : inrow - 1);
            int thiscs = r0[0] * 3 + r1[0], nextcs = r0[1] * 3 + r1[1], lastcs;
            o[0] = (uint8_t)((thiscs * 4 + 8) >> 4);
            o[1] = (uint8_t)((thiscs * 3 + nextcs + 7) >> 4);
            lastcs = thiscs;
            thiscs = nextcs;
            for (int x = 1; x < W - 1; ++x) {
                nextcs = r0[x + 1] * 3 + r1[x + 1];
                o[2 * x] = (uint8_t)((thiscs * 3 + lastcs + 8) >> 4);
                o[2 * x + 1] = (uint8_t)((thiscs * 3 + nextcs + 7) >> 4);
                lastcs = thiscs;
                thiscs = nextcs;
            }
            o[2 * W - 2] = (uint8_t)((thiscs * 3 + lastcs + 8) >> 4);
            o[2 * W - 1] = (uint8_t)((thiscs * 4 + 7) >> 4);
        }
    }
    memcpy(out, o, out_w);
}

struct YccTables {  // jdcolor.c build_ycc_rgb_table
    int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
    YccTables() {
        const int one_half = 1 << 15;
        auto fix = [](double x) { return (int)(x * 65536.0 + 0.5); };
        for (int i = 0; i < 256; ++i) {
            int x = i - 128;
            cr_r[i] = (fix(1.40200) * x + one_half) >> 16;
            cb_b[i] = (fix(1.77200) * x + one_half) >> 16;
            cr_g[i] = -fix(0.71414) * x;
            cb_g[i] = -fix(0.34414) * x + one_half;
        }
    }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

}  // namespace

extern "C" {

const char* codec_error() { return g_err; }

int codec_abi_version() { return 1; }

// -> 0 and the image's height, width and component count, or -1
int jpeg_header(const uint8_t* data, int64_t n, int* h, int* w, int* comps) {
    Jpeg j;
    j.p = data;
    j.n = (size_t)n;
    if (jpeg_parse(j, false)) return -1;
    *h = j.height;
    *w = j.width;
    *comps = j.ncomp;
    return 0;
}

// decode into RGB uint8 [h, w, 3] (gray replicated); h and w from jpeg_header
int jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int h, int w) {
    Jpeg j;
    j.p = data;
    j.n = (size_t)n;
    if (jpeg_parse(j, true)) return -1;
    if (j.height != h || j.width != w) return fail("JPEG is %dx%d, the buffer %dx%d", j.height, j.width, h, w);
    std::vector<uint8_t> rows(3 * (size_t)w);
    bool rgb = j.ncomp == 3 && (j.adobe_transform == 0 ||
                                (j.comp[0].id == 'R' && j.comp[1].id == 'G' && j.comp[2].id == 'B'));
    for (int y = 0; y < h; ++y) {
        uint8_t* o = out + (size_t)y * w * 3;
        if (j.ncomp == 1) {
            upsample_row(j.comp[0], j.hmax, j.vmax, y, rows.data(), w);
            for (int x = 0; x < w; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = rows[x];
            continue;
        }
        uint8_t* yy = rows.data();
        uint8_t* cb = yy + w;
        uint8_t* cr = cb + w;
        upsample_row(j.comp[0], j.hmax, j.vmax, y, yy, w);
        upsample_row(j.comp[1], j.hmax, j.vmax, y, cb, w);
        upsample_row(j.comp[2], j.hmax, j.vmax, y, cr, w);
        if (rgb) {
            for (int x = 0; x < w; ++x) {
                o[3 * x] = yy[x];
                o[3 * x + 1] = cb[x];
                o[3 * x + 2] = cr[x];
            }
            continue;
        }
        for (int x = 0; x < w; ++x) {
            int Y = yy[x], B = cb[x], R = cr[x];
            o[3 * x] = clamp255(Y + kYcc.cr_r[R]);
            o[3 * x + 1] = clamp255(Y + ((kYcc.cb_g[B] + kYcc.cr_g[R]) >> 16));
            o[3 * x + 2] = clamp255(Y + kYcc.cb_b[B]);
        }
    }
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// JPEG encoder
// ---------------------------------------------------------------------------

namespace {

// Annex K tables in zigzag order, as libjpeg writes them at quality 50
const uint8_t kStdLuma[64] = {
    16, 11, 12, 14, 12, 10, 16, 14, 13, 14, 18, 17, 16, 19, 24,  40,  26,  24,  22,  22, 24, 49,
    35, 37, 29, 40, 58, 51, 61, 60, 57, 51, 56, 55, 64, 72, 92,  78,  64,  68,  87,  69, 55, 56,
    80, 109, 81, 87, 95, 98, 103, 104, 103, 62, 77, 113, 121, 112, 100, 120, 92, 101, 103, 99};
const uint8_t kStdChroma[64] = {
    17, 18, 18, 24, 21, 24, 47, 26, 26, 47, 99, 66, 56, 66, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// the standard Huffman tables (jstdhuff.c): 16 counts, then the values
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71,
    0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37,
    0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22,
    0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36,
    0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct EHuff {
    uint16_t code[256];
    uint8_t size[256];
    EHuff(const uint8_t* bits, const uint8_t* vals) {
        memset(size, 0, sizeof(size));
        int c = 0, k = 0;
        for (int l = 1; l <= 16; ++l) {
            for (int i = 0; i < bits[l - 1]; ++i, ++k, ++c) {
                code[vals[k]] = (uint16_t)c;
                size[vals[k]] = (uint8_t)l;
            }
            c <<= 1;
        }
    }
};
const EHuff kEDcLuma(kDcLumaBits, kDcVals), kEDcChroma(kDcChromaBits, kDcVals);
const EHuff kEAcLuma(kAcLumaBits, kAcLumaVals), kEAcChroma(kAcChromaBits, kAcChromaVals);

struct BitWriter {
    std::vector<uint8_t>& out;
    uint32_t acc = 0;
    int cnt = 0;
    explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
    void put(uint32_t code, int size) {
        acc = (acc << size) | (code & ((1u << size) - 1));
        cnt += size;
        while (cnt >= 8) {
            uint8_t b = (uint8_t)(acc >> (cnt - 8));
            out.push_back(b);
            if (b == 0xFF) out.push_back(0);
            cnt -= 8;
        }
    }
    void flush() {
        if (cnt) put(0x7F, 7 - ((cnt - 1) % 8));  // pad with one bits
        cnt = 0;
        acc = 0;
    }
};

// jfdctint.c (ISLOW): CONST_BITS 13, PASS1_BITS 2
void fdct_islow(int* d) {
    const int c13 = 13, p1 = 2;
    auto desc = [](long long x, int n) { return (int)((x + (1LL << (n - 1))) >> n); };
    for (int pass = 0; pass < 2; ++pass) {
        for (int i = 0; i < 8; ++i) {
            int s = pass == 0 ? 1 : 8;
            int* p = pass == 0 ? d + 8 * i : d + i;
            long long tmp0 = p[0] + p[7 * s], tmp7 = p[0] - p[7 * s];
            long long tmp1 = p[s] + p[6 * s], tmp6 = p[s] - p[6 * s];
            long long tmp2 = p[2 * s] + p[5 * s], tmp5 = p[2 * s] - p[5 * s];
            long long tmp3 = p[3 * s] + p[4 * s], tmp4 = p[3 * s] - p[4 * s];
            long long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
            int sh = pass == 0 ? c13 - p1 : c13 + p1;
            if (pass == 0) {
                p[0] = (int)((tmp10 + tmp11) << p1);
                p[4 * s] = (int)((tmp10 - tmp11) << p1);
            } else {
                p[0] = desc(tmp10 + tmp11, p1);
                p[4 * s] = desc(tmp10 - tmp11, p1);
            }
            long long z1 = (tmp12 + tmp13) * 4433;
            p[2 * s] = desc(z1 + tmp13 * 6270, sh);
            p[6 * s] = desc(z1 + tmp12 * -15137, sh);
            z1 = tmp4 + tmp7;
            long long z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
            long long z5 = (z3 + z4) * 9633;
            tmp4 *= 2446;
            tmp5 *= 16819;
            tmp6 *= 25172;
            tmp7 *= 12299;
            z1 *= -7373;
            z2 *= -20995;
            z3 *= -16069;
            z4 *= -3196;
            z3 += z5;
            z4 += z5;
            p[7 * s] = desc(tmp4 + z1 + z3, sh);
            p[5 * s] = desc(tmp5 + z2 + z4, sh);
            p[3 * s] = desc(tmp6 + z2 + z3, sh);
            p[s] = desc(tmp7 + z1 + z4, sh);
        }
    }
}

// jcdctmgr.c: quantization by reciprocal (16-bit DCTELEM), as libjpeg-turbo does
struct Divisor {
    uint32_t recip, corr;
    int shift;
    explicit Divisor(int d = 1) {
        if (d == 1) {
            recip = 1; corr = 0; shift = 0;
            return;
        }
        int b = 31 - __builtin_clz((unsigned)d);
        int r = 16 + b;
        uint32_t fq = (uint32_t)((1ull << r) / d), fr = (uint32_t)((1ull << r) % d);
        uint32_t c = d / 2;
        if (fr == 0) {
            fq >>= 1;
            --r;
        } else if (fr <= (uint32_t)d / 2) {
            ++c;
        } else {
            ++fq;
        }
        recip = fq;
        corr = c;
        shift = r;
    }
    int apply(int v) const {
        if (recip == 1 && shift == 0) return v;
        uint32_t a = (uint32_t)(v < 0 ? -v : v);
        uint32_t q = (uint32_t)(((uint64_t)(a + corr) * recip) >> shift);
        return v < 0 ? -(int)q : (int)q;
    }
};

void put_u16(std::vector<uint8_t>& o, int v) {
    o.push_back((uint8_t)(v >> 8));
    o.push_back((uint8_t)v);
}

void put_dht(std::vector<uint8_t>& o, int tc_th, const uint8_t* bits, const uint8_t* vals) {
    int n = 0;
    for (int i = 0; i < 16; ++i) n += bits[i];
    o.push_back(0xFF);
    o.push_back(0xC4);
    put_u16(o, 2 + 1 + 16 + n);
    o.push_back((uint8_t)tc_th);
    o.insert(o.end(), bits, bits + 16);
    o.insert(o.end(), vals, vals + n);
}

int bitlen(int v) {
    v = v < 0 ? -v : v;
    int n = 0;
    while (v) {
        ++n;
        v >>= 1;
    }
    return n;
}

void encode_block(BitWriter& bw, const int* coef_natural, int& last_dc, const EHuff& dc, const EHuff& ac) {
    int diff = coef_natural[0] - last_dc;
    last_dc = coef_natural[0];
    int nb = bitlen(diff);
    bw.put(dc.code[nb], dc.size[nb]);
    if (nb) bw.put((uint32_t)(diff < 0 ? diff - 1 : diff), nb);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
        int v = coef_natural[kNatural[k]];
        if (!v) {
            ++run;
            continue;
        }
        while (run > 15) {
            bw.put(ac.code[0xF0], ac.size[0xF0]);
            run -= 16;
        }
        nb = bitlen(v);
        int sym = (run << 4) | nb;
        bw.put(ac.code[sym], ac.size[sym]);
        bw.put((uint32_t)(v < 0 ? v - 1 : v), nb);
        run = 0;
    }
    if (run) bw.put(ac.code[0], ac.size[0]);
}

}  // namespace

extern "C" {

// RGB uint8 [h, w, 3] -> baseline JPEG bytes, as tf.io.encode_jpeg(quality=q)
// writes them (4:2:0 when subsample, else 4:4:4). Returns the size written, or
// -(size needed) when cap is too small, or -1 on a bad argument.
int64_t jpeg_encode(const uint8_t* rgb, int h, int w, int quality, int subsample, uint8_t* out, int64_t cap) {
    if (h <= 0 || w <= 0 || h > 65535 || w > 65535) return fail("JPEG size %dx%d out of range", h, w);
    if (quality < 1 || quality > 100) return fail("JPEG quality %d outside [1, 100]", quality);
    int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;  // jcparam.c jpeg_quality_scaling
    uint8_t qz[2][64];  // zigzag order
    for (int i = 0; i < 64; ++i) {
        long t0 = (kStdLuma[i] * (long)scale + 50) / 100, t1 = (kStdChroma[i] * (long)scale + 50) / 100;
        qz[0][i] = (uint8_t)std::min(255L, std::max(1L, t0));
        qz[1][i] = (uint8_t)std::min(255L, std::max(1L, t1));
    }
    Divisor div[2][64];  // natural order, ISLOW's divisors are q << 3
    for (int t = 0; t < 2; ++t)
        for (int i = 0; i < 64; ++i) div[t][kNatural[i]] = Divisor(qz[t][i] << 3);

    const int hs = subsample ? 2 : 1;
    const int mcu = 8 * hs;
    const int mcux = (w + mcu - 1) / mcu, mcuy = (h + mcu - 1) / mcu;
    // jccolor.c rgb_ycc_convert
    const int one_half = 1 << 15, cbcr_off = 128 << 16;
    auto fix = [](double x) { return (int)(x * 65536.0 + 0.5); };
    std::vector<uint8_t> Y((size_t)h * w), Cb((size_t)h * w), Cr((size_t)h * w);
    for (size_t i = 0; i < (size_t)h * w; ++i) {
        int r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
        Y[i] = (uint8_t)((fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + one_half) >> 16);
        Cb[i] = (uint8_t)((-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + cbcr_off + one_half - 1) >> 16);
        Cr[i] = (uint8_t)((fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + cbcr_off + one_half - 1) >> 16);
    }
    // component planes padded as jcprepct.c / jcsample.c pad them: columns by
    // replicating the last one to whole blocks, rows to whole iMCU rows
    const int lw_blocks = (w + 7) / 8, lh_blocks = (h + 7) / 8;
    const int cw = subsample ? (w + 1) / 2 : w, ch = subsample ? (h + 1) / 2 : h;
    const int cw_blocks = (cw + 7) / 8, ch_blocks = (ch + 7) / 8;
    const int lpw = lw_blocks * 8, lph = mcuy * mcu;
    const int cpw = cw_blocks * 8, cph = mcuy * 8;
    std::vector<uint8_t> L((size_t)lpw * lph), C1((size_t)cpw * cph), C2((size_t)cpw * cph);
    for (int y = 0; y < lph; ++y) {
        const uint8_t* src = Y.data() + (size_t)std::min(y, h - 1) * w;
        uint8_t* d = L.data() + (size_t)y * lpw;
        for (int x = 0; x < lpw; ++x) d[x] = src[std::min(x, w - 1)];
    }
    if (subsample) {  // h2v2_downsample with the 1, 2, 1, 2 ... bias
        const int inw = cpw * 2;
        for (int y = 0; y < ch; ++y) {
            int y0 = std::min(2 * y, h - 1), y1 = std::min(2 * y + 1, h - 1);
            for (int pl = 0; pl < 2; ++pl) {
                const std::vector<uint8_t>& S = pl ? Cr : Cb;
                uint8_t* d = (pl ? C2 : C1).data() + (size_t)y * cpw;
                const uint8_t* r0 = S.data() + (size_t)y0 * w;
                const uint8_t* r1 = S.data() + (size_t)y1 * w;
                int bias = 1;
                for (int x = 0; x < cpw; ++x) {
                    int a = std::min(2 * x, inw - 1), b = std::min(2 * x + 1, inw - 1);
                    a = std::min(a, w - 1);
                    b = std::min(b, w - 1);
                    d[x] = (uint8_t)((r0[a] + r0[b] + r1[a] + r1[b] + bias) >> 2);
                    bias ^= 3;
                }
            }
        }
    } else {
        for (int y = 0; y < ch; ++y)
            for (int x = 0; x < cpw; ++x) {
                size_t s = (size_t)y * w + std::min(x, w - 1);
                C1[(size_t)y * cpw + x] = Cb[s];
                C2[(size_t)y * cpw + x] = Cr[s];
            }
    }
    for (int pl = 0; pl < 2; ++pl) {  // replicate the last chroma row to the iMCU height
        uint8_t* P = (pl ? C2 : C1).data();
        for (int y = ch; y < cph; ++y) memcpy(P + (size_t)y * cpw, P + (size_t)(ch - 1) * cpw, cpw);
    }

    std::vector<uint8_t> o;
    o.reserve((size_t)h * w + 1024);
    const uint8_t head[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00,
                            0x01, 0x01, 0x01, 0x01, 0x2C, 0x01, 0x2C, 0x00, 0x00};
    o.insert(o.end(), head, head + sizeof(head));
    for (int t = 0; t < 2; ++t) {
        o.push_back(0xFF);
        o.push_back(0xDB);
        put_u16(o, 67);
        o.push_back((uint8_t)t);
        o.insert(o.end(), qz[t], qz[t] + 64);
    }
    o.push_back(0xFF);
    o.push_back(0xC0);
    put_u16(o, 17);
    o.push_back(8);
    put_u16(o, h);
    put_u16(o, w);
    o.push_back(3);
    const uint8_t samp = subsample ? 0x22 : 0x11;
    const uint8_t comps[9] = {1, samp, 0, 2, 0x11, 1, 3, 0x11, 1};
    o.insert(o.end(), comps, comps + 9);
    put_dht(o, 0x00, kDcLumaBits, kDcVals);
    put_dht(o, 0x10, kAcLumaBits, kAcLumaVals);
    put_dht(o, 0x01, kDcChromaBits, kDcVals);
    put_dht(o, 0x11, kAcChromaBits, kAcChromaVals);
    const uint8_t sos[] = {0xFF, 0xDA, 0x00, 0x0C, 0x03, 0x01, 0x00, 0x02, 0x11, 0x03, 0x11, 0x00, 0x3F, 0x00};
    o.insert(o.end(), sos, sos + sizeof(sos));

    BitWriter bw(o);
    int dc[3] = {0, 0, 0};
    int blk[64], q[64];
    auto fdct_q = [&](const uint8_t* plane, int pw, int x0, int y0, int t) {
        for (int r = 0; r < 8; ++r)
            for (int c = 0; c < 8; ++c) blk[8 * r + c] = (int)plane[(size_t)(y0 + r) * pw + x0 + c] - 128;
        fdct_islow(blk);
        for (int i = 0; i < 64; ++i) q[i] = div[t][i].apply(blk[i]);
    };
    for (int my = 0; my < mcuy; ++my) {
        for (int mx = 0; mx < mcux; ++mx) {
            int prev_q0 = 0;
            for (int by = 0; by < hs; ++by) {
                for (int bx = 0; bx < hs; ++bx) {
                    int bcol = mx * hs + bx, brow = my * hs + by;
                    if (bcol < lw_blocks && brow < lh_blocks) {
                        fdct_q(L.data(), lpw, bcol * 8, brow * 8, 0);
                    } else {  // jccoefct.c dummy block: the previous block's DC, no AC
                        memset(q, 0, sizeof(q));
                        q[0] = prev_q0;
                    }
                    prev_q0 = q[0];
                    encode_block(bw, q, dc[0], kEDcLuma, kEAcLuma);
                }
            }
            for (int pl = 0; pl < 2; ++pl) {
                if (mx < cw_blocks && my < ch_blocks) {
                    fdct_q((pl ? C2 : C1).data(), cpw, mx * 8, my * 8, 1);
                } else {
                    memset(q, 0, sizeof(q));
                    q[0] = 0;
                }
                encode_block(bw, q, dc[1 + pl], kEDcChroma, kEAcChroma);
            }
        }
    }
    bw.flush();
    o.push_back(0xFF);
    o.push_back(0xD9);
    if ((int64_t)o.size() > cap) return -(int64_t)o.size();
    memcpy(out, o.data(), o.size());
    return (int64_t)o.size();
}

// ---------------------------------------------------------------------------
// PNG rows
// ---------------------------------------------------------------------------

// inflated PNG rows (a filter byte, then w * channels bytes each) -> RGB
// uint8 [h, w, 3]: filters 0-4 undone, alpha dropped, gray replicated
int png_unfilter(const uint8_t* raw, int64_t n, int h, int w, int channels, uint8_t* out) {
    const int64_t stride = (int64_t)w * channels;
    if (channels < 1 || channels > 4) return fail("PNG with %d channels", channels);
    if (n < (stride + 1) * h) return fail("PNG image data too short: %lld bytes for %dx%dx%d", (long long)n, h, w, channels);
    std::vector<uint8_t> prev(stride, 0), cur(stride);
    const int bpp = channels;
    for (int y = 0; y < h; ++y) {
        const uint8_t* r = raw + (int64_t)y * (stride + 1);
        int f = r[0];
        const uint8_t* s = r + 1;
        for (int64_t i = 0; i < stride; ++i) {
            int a = i >= bpp ? cur[i - bpp] : 0, b = prev[i], c = i >= bpp ? prev[i - bpp] : 0, x = s[i];
            switch (f) {
                case 0: break;
                case 1: x += a; break;
                case 2: x += b; break;
                case 3: x += (a + b) >> 1; break;
                case 4: {
                    int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
                    x += (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                    break;
                }
                default: return fail("PNG row %d has filter type %d", y, f);
            }
            cur[i] = (uint8_t)x;
        }
        uint8_t* o = out + (int64_t)y * w * 3;
        for (int x = 0; x < w; ++x) {
            const uint8_t* px = cur.data() + (int64_t)x * channels;
            if (channels <= 2) {
                o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = px[0];
            } else {
                o[3 * x] = px[0];
                o[3 * x + 1] = px[1];
                o[3 * x + 2] = px[2];
            }
        }
        std::swap(prev, cur);
    }
    return 0;
}

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli), slicing by 8
// ---------------------------------------------------------------------------

}  // extern "C"

namespace {
struct Crc32cTable {
    uint32_t t[8][256];
    Crc32cTable() {
        for (uint32_t i = 0; i < 256; ++i) {
            uint32_t c = i;
            for (int k = 0; k < 8; ++k) c = c & 1 ? (c >> 1) ^ 0x82F63B78u : c >> 1;
            t[0][i] = c;
        }
        for (uint32_t i = 0; i < 256; ++i)
            for (int s = 1; s < 8; ++s) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
    }
};
const Crc32cTable kCrc;
}  // namespace

extern "C" {

uint32_t crc32c(const uint8_t* p, int64_t n) {
    uint32_t c = 0xFFFFFFFFu;
    while (n >= 8) {
        uint32_t lo, hi;
        memcpy(&lo, p, 4);
        memcpy(&hi, p + 4, 4);
        lo ^= c;
        c = kCrc.t[7][lo & 0xFF] ^ kCrc.t[6][(lo >> 8) & 0xFF] ^ kCrc.t[5][(lo >> 16) & 0xFF] ^ kCrc.t[4][lo >> 24] ^
            kCrc.t[3][hi & 0xFF] ^ kCrc.t[2][(hi >> 8) & 0xFF] ^ kCrc.t[1][(hi >> 16) & 0xFF] ^ kCrc.t[0][hi >> 24];
        p += 8;
        n -= 8;
    }
    while (n-- > 0) c = kCrc.t[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// frame transforms
// ---------------------------------------------------------------------------

namespace {

// scale_and_translate_op.cc ComputeSpansCore with the lanczos3 kernel and
// zero translation; antialias widens the kernel by the downscale factor
struct Spans {
    int span;
    std::vector<int> start;
    std::vector<float> weight;  // [out, span]
};

float lanczos3(float x) {
    constexpr float kPI = 3.14159265359f;
    const float radius = 3.0f;
    x = std::abs(x);
    if (x > radius) return 0.0f;
    if (x <= 1e-3f) return 1.0f;
    return radius * std::sin(kPI * x) * std::sin(kPI * x / radius) / (kPI * kPI * x * x);
}

Spans spans(int out_size, int in_size, bool antialias) {
    const float scale = (float)out_size / (float)in_size;
    const float inv_scale = (float)(1.0 / (double)scale);
    const float kernel_scale = antialias ? std::max(inv_scale, 1.0f) : 1.0f;
    const float reach = 3.0f * kernel_scale, inv_kernel_scale = 1.0f / kernel_scale;
    Spans s;
    s.span = std::min(2 * (int)std::ceil(reach) + 1, in_size);
    s.start.assign(out_size, 0);
    s.weight.assign((size_t)out_size * s.span, 0.0f);
    std::vector<float> tmp;
    for (int x = 0; x < out_size; ++x) {
        const float sample_f = ((float)x + 0.5f) * inv_scale;
        if (sample_f < 0 || sample_f > (float)in_size) continue;
        long lo = (long)std::ceil(sample_f - reach - 0.5f), hi = (long)std::floor(sample_f + reach - 0.5f);
        lo = std::min(std::max(lo, 0L), (long)in_size - 1);
        hi = std::min(std::max(hi, 0L), (long)in_size - 1) + 1;
        float total = 0.0f;
        tmp.clear();
        for (long src = lo; src < hi; ++src) {
            float w = lanczos3(std::abs(((float)src + 0.5f - sample_f) * inv_kernel_scale));
            total += w;
            tmp.push_back(w);
        }
        if (std::abs(total) >= 1000.0f * 1.17549435e-38f) {
            float inv = 1.0f / total;
            for (size_t i = 0; i < tmp.size(); ++i) s.weight[(size_t)x * s.span + i] = tmp[i] * inv;
        }
        s.start[x] = (int)lo;
    }
    return s;
}

}  // namespace

extern "C" {

// uint8 [sh, sw, c] -> uint8 [dh, dw, c]: lanczos3 in float (rows, then
// columns, as TF gathers them), optionally antialiased; rounded half to even
// (tf.round) when `round_even`, else truncated; clipped to [0, 255]
int resize_lanczos3_u8(const uint8_t* src, int sh, int sw, int c, uint8_t* dst, int dh, int dw, int antialias,
                       int round_even) {
    if (sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0 || c <= 0) return fail("resize: empty image");
    Spans rs = spans(dh, sh, antialias), cs = spans(dw, sw, antialias);
    const int rowlen = sw * c;
    std::vector<float> mid((size_t)dh * rowlen, 0.0f);
    for (int y = 0; y < dh; ++y) {
        float* o = mid.data() + (size_t)y * rowlen;
        const int real = std::min(rs.start[y] + rs.span, sh) - rs.start[y];
        const uint8_t* in = src + (size_t)rs.start[y] * rowlen;
        for (int k = 0; k < real; ++k, in += rowlen) {
            float wgt = rs.weight[(size_t)y * rs.span + k];
            for (int x = 0; x < rowlen; ++x) o[x] += wgt * (float)in[x];
        }
    }
    for (int y = 0; y < dh; ++y) {
        const float* in_row = mid.data() + (size_t)y * rowlen;
        uint8_t* o = dst + (size_t)y * dw * c;
        for (int x = 0; x < dw; ++x) {
            const int real = std::min(cs.start[x] + cs.span, sw) - cs.start[x];
            for (int ch = 0; ch < c; ++ch) {
                float acc = 0.0f;
                const float* in = in_row + (size_t)cs.start[x] * c + ch;
                for (int k = 0; k < real; ++k) acc += cs.weight[(size_t)x * cs.span + k] * in[(size_t)k * c];
                if (round_even) acc = std::nearbyint(acc);  // the default rounding mode: ties to even
                acc = acc < 0.0f ? 0.0f : acc > 255.0f ? 255.0f : acc;
                o[(size_t)x * c + ch] = (uint8_t)acc;
            }
        }
    }
    return 0;
}

}  // extern "C"

namespace {

// imgproc/resize.cpp interpolateLanczos4 and the 8-bit fixed-point taps
// (INTER_RESIZE_COEF_SCALE 2048, saturate_cast<short> rounding to nearest even)
void lanczos4_taps(int out_size, int in_size, std::vector<int>& start, std::vector<int>& taps) {
    static const double s45 = 0.70710678118654752440084436210485;
    static const double cs[8][2] = {{1, 0}, {-s45, -s45}, {0, 1}, {s45, -s45}, {-1, 0}, {s45, s45}, {0, -1}, {-s45, s45}};
    const double scale = 1.0 / ((double)out_size / in_size);
    start.assign(out_size, 0);
    taps.assign((size_t)out_size * 8, 0);
    for (int d = 0; d < out_size; ++d) {
        float f = (float)((d + 0.5) * scale - 0.5);
        int sx = (int)std::floor(f);
        f -= (float)sx;
        const double y0 = -(f + 3) * M_PI * 0.25, s0 = std::sin(y0), c0 = std::cos(y0);
        float coef[8], sum = 0.0f;
        for (int i = 0; i < 8; ++i) {
            float yi = f + 3 - i;
            if (std::fabs(yi) >= 1e-6f) {
                double y = -yi * M_PI * 0.25;
                coef[i] = (float)((cs[i][0] * s0 + cs[i][1] * c0) / (y * y));
            } else {
                coef[i] = 1e30f;
            }
            sum += coef[i];
        }
        sum = 1.f / sum;
        for (int i = 0; i < 8; ++i) taps[(size_t)d * 8 + i] = (int)std::lrintf(coef[i] * sum * 2048.0f);
        start[d] = sx - 3;
    }
}

}  // namespace

extern "C" {

// uint8 [sh, sw, c] -> uint8 [dh, dw, c] as cv2.resize(INTER_LANCZOS4) computes
// 8-bit images: 8 fixed-point taps per axis (rows of taps clamped at the
// borders), horizontal then vertical, rounded by 2^22
int resize_lanczos4_cv_u8(const uint8_t* src, int sh, int sw, int c, uint8_t* dst, int dh, int dw) {
    if (sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0 || c <= 0) return fail("resize: empty image");
    std::vector<int> xs, xt, ys, yt;
    lanczos4_taps(dw, sw, xs, xt);
    lanczos4_taps(dh, sh, ys, yt);
    std::vector<int> mid((size_t)sh * dw * c);
    for (int y = 0; y < sh; ++y) {
        const uint8_t* row = src + (size_t)y * sw * c;
        int* o = mid.data() + (size_t)y * dw * c;
        for (int x = 0; x < dw; ++x)
            for (int k = 0; k < c; ++k) {
                int v = 0;
                for (int j = 0; j < 8; ++j) {
                    int sx = std::min(std::max(xs[x] + j, 0), sw - 1);
                    v += row[(size_t)sx * c + k] * xt[(size_t)x * 8 + j];
                }
                o[(size_t)x * c + k] = v;
            }
    }
    const size_t rowlen = (size_t)dw * c;
    for (int y = 0; y < dh; ++y) {
        uint8_t* o = dst + (size_t)y * rowlen;
        for (size_t i = 0; i < rowlen; ++i) {
            int v = 0;
            for (int j = 0; j < 8; ++j) {
                int sy = std::min(std::max(ys[y] + j, 0), sh - 1);
                v += mid[(size_t)sy * rowlen + i] * yt[(size_t)y * 8 + j];
            }
            o[i] = clamp255((v + (1 << 21)) >> 22);
        }
    }
    return 0;
}

// The train path's augment of one RGB frame (tf_transforms._crop_resize_jitter_tf):
// a crop of side sqrt(scale) at offsets (off_y, off_x) in [0, 1) bilinearly
// resized to [dh, dw] (crop_and_resize), /255, + brightness, contrast around
// the per-channel mean, one RGB->HSV->RGB trip scaling saturation and
// shifting hue, clip to [0, 1], x255, truncate.
int crop_resize_jitter_u8(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh, int dw, float scale,
                          float off_y, float off_x, float brightness, float contrast, float saturation,
                          float hue) {
    if (sh < 2 || sw < 2 || dh <= 0 || dw <= 0) return fail("crop_resize_jitter: frame too small");
    const float h = (float)sh, w = (float)sw;
    const float side = std::sqrt(scale);
    const float ch = std::floor(h * side), cw = std::floor(w * side);
    const float oy = std::floor(off_y * (h - ch + 1.0f)), ox = std::floor(off_x * (w - cw + 1.0f));
    const float y1 = oy / (h - 1.0f), x1 = ox / (w - 1.0f);
    const float y2 = (oy + ch - 1.0f) / (h - 1.0f), x2 = (ox + cw - 1.0f) / (w - 1.0f);
    // crop_and_resize_op.cc (bilinear)
    const float hsc = dh > 1 ? (y2 - y1) * (float)(sh - 1) / (float)(dh - 1) : 0.0f;
    const float wsc = dw > 1 ? (x2 - x1) * (float)(sw - 1) / (float)(dw - 1) : 0.0f;
    std::vector<float> img((size_t)dh * dw * 3);
    std::vector<int> xl(dw), xr(dw);
    std::vector<char> xin(dw);
    std::vector<float> xf(dw);
    for (int x = 0; x < dw; ++x) {
        float in_x = dw > 1 ? x1 * (float)(sw - 1) + (float)x * wsc : 0.5f * (x1 + x2) * (float)(sw - 1);
        xin[x] = in_x >= 0.0f && in_x <= (float)(sw - 1);  // else TF writes the extrapolation value 0
        xl[x] = xin[x] ? (int)std::floor(in_x) : 0;
        xr[x] = xin[x] ? (int)std::ceil(in_x) : 0;
        xf[x] = in_x - std::floor(in_x);
    }
    double sum[3] = {0, 0, 0};
    for (int y = 0; y < dh; ++y) {
        float in_y = dh > 1 ? y1 * (float)(sh - 1) + (float)y * hsc : 0.5f * (y1 + y2) * (float)(sh - 1);
        const bool yin = in_y >= 0.0f && in_y <= (float)(sh - 1);
        int ty = yin ? (int)std::floor(in_y) : 0, by = yin ? (int)std::ceil(in_y) : 0;
        float yl = in_y - std::floor(in_y);
        const uint8_t* top = src + (size_t)ty * sw * 3;
        const uint8_t* bot = src + (size_t)by * sw * 3;
        float* o = img.data() + (size_t)y * dw * 3;
        for (int x = 0; x < dw; ++x) {
            for (int k = 0; k < 3; ++k) {
                float tl = top[3 * xl[x] + k], tr = top[3 * xr[x] + k];
                float bl = bot[3 * xl[x] + k], br = bot[3 * xr[x] + k];
                float t = tl + (tr - tl) * xf[x];
                float b = bl + (br - bl) * xf[x];
                float v = ((yin && xin[x]) ? t + (b - t) * yl : 0.0f) / 255.0f + brightness;
                o[3 * x + k] = v;
                sum[k] += v;
            }
        }
    }
    const float npx = (float)dh * (float)dw;
    float mean[3];
    for (int k = 0; k < 3; ++k) mean[k] = (float)(sum[k] / (double)npx);
    for (size_t i = 0; i < (size_t)dh * dw; ++i) {
        float r = (img[3 * i] - mean[0]) * contrast + mean[0];
        float g = (img[3 * i + 1] - mean[1]) * contrast + mean[1];
        float b = (img[3 * i + 2] - mean[2]) * contrast + mean[2];
        r = std::min(std::max(r, 0.0f), 1.0f);
        g = std::min(std::max(g, 0.0f), 1.0f);
        b = std::min(std::max(b, 0.0f), 1.0f);
        // colorspace_op.h RGBToHSV
        float v = std::max(r, std::max(g, b));
        float range = v - std::min(r, std::min(g, b));
        float s = v > 0.0f ? range / v : 0.0f;
        float norm = (1.0f / range) * (1.0f / 6.0f);
        float hh = r == v ? norm * (g - b) : (g == v ? norm * (b - r) + 2.0f / 6.0f : norm * (r - g) + 4.0f / 6.0f);
        if (!(range > 0.0f)) hh = 0.0f;
        if (hh < 0.0f) hh += 1.0f;
        // floormod(h + hue, 1), then saturation
        float hm = std::fmod(hh + hue, 1.0f);
        if (hm != 0.0f && hm < 0.0f) hm += 1.0f;
        s = std::min(std::max(s * saturation, 0.0f), 1.0f);
        // colorspace_op.h HSVToRGB
        float dhh = hm * 6.0f;
        float dr = std::min(std::max(std::abs(dhh - 3.0f) - 1.0f, 0.0f), 1.0f);
        float dg = std::min(std::max(-std::abs(dhh - 2.0f) + 2.0f, 0.0f), 1.0f);
        float db = std::min(std::max(-std::abs(dhh - 4.0f) + 2.0f, 0.0f), 1.0f);
        float one_s = -s + 1.0f;
        float rgb[3] = {(one_s + s * dr) * v, (one_s + s * dg) * v, (one_s + s * db) * v};
        for (int k = 0; k < 3; ++k) {
            float x = std::min(std::max(rgb[k], 0.0f), 1.0f) * 255.0f;
            dst[3 * i + k] = (uint8_t)x;
        }
    }
    return 0;
}

}  // extern "C"
