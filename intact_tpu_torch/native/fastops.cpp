// fastops: native host-side ops for the serving/data hot path.
//
// The reference leans on cv2 + numpy for per-request image work
// (resize -> float cast -> normalize -> batch concat, each a separate pass
// over the pixels; SURVEY.md §2.5/2.6). These routines fuse the passes and
// drop the Python loop overhead in the continuous-batching server:
//
//   resize_bilinear_u8    uint8 HWC resize (separable bilinear)
//   u8_to_normalized_f32  uint8 -> float32 (x * scale + offset), one pass
//   assemble_batch_f32    N uint8 frames -> one [N,H,W,C] normalized f32
//                         buffer (resize fused when shapes differ)
//
// Exposed with C linkage for ctypes (no pybind11 in this image). All
// functions are thread-safe and allocation-free (callers own the buffers).

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Separable bilinear resize, uint8, channels-last. Matches cv2
// INTER_LINEAR pixel-center convention: src_x = (x + 0.5) * sx - 0.5.
void resize_bilinear_u8(const uint8_t* src, int sh, int sw, int c,
                        uint8_t* dst, int dh, int dw) {
    const float sx = static_cast<float>(sw) / dw;
    const float sy = static_cast<float>(sh) / dh;
    for (int y = 0; y < dh; ++y) {
        float fy = (y + 0.5f) * sy - 0.5f;
        int y0 = static_cast<int>(fy);
        if (fy < 0) { fy = 0; y0 = 0; }
        int y1 = std::min(y0 + 1, sh - 1);
        const float wy = fy - y0;
        const uint8_t* row0 = src + static_cast<size_t>(y0) * sw * c;
        const uint8_t* row1 = src + static_cast<size_t>(y1) * sw * c;
        uint8_t* out = dst + static_cast<size_t>(y) * dw * c;
        for (int x = 0; x < dw; ++x) {
            float fx = (x + 0.5f) * sx - 0.5f;
            int x0 = static_cast<int>(fx);
            if (fx < 0) { fx = 0; x0 = 0; }
            int x1 = std::min(x0 + 1, sw - 1);
            const float wx = fx - x0;
            for (int k = 0; k < c; ++k) {
                const float top = row0[x0 * c + k] * (1 - wx) + row0[x1 * c + k] * wx;
                const float bot = row1[x0 * c + k] * (1 - wx) + row1[x1 * c + k] * wx;
                const float v = top * (1 - wy) + bot * wy;
                out[x * c + k] = static_cast<uint8_t>(v + 0.5f);
            }
        }
    }
}

// One-pass uint8 -> float32 affine: dst = src * scale + offset.
// scale = 2/255, offset = -1 gives the SigLIP [-1, 1] input range.
void u8_to_normalized_f32(const uint8_t* src, float* dst, int64_t n,
                          float scale, float offset) {
    // lookup table: only 256 possible inputs
    float lut[256];
    for (int i = 0; i < 256; ++i) lut[i] = i * scale + offset;
    for (int64_t i = 0; i < n; ++i) dst[i] = lut[src[i]];
}

// Assemble N frames (possibly of differing source sizes) into one
// normalized float32 batch [n, dh, dw, c]. srcs[i] points at frame i with
// dims (shs[i], sws[i], c). Frames already at (dh, dw) skip the resize.
// scratch must hold dh*dw*c bytes (per call; caller may reuse).
void assemble_batch_f32(const uint8_t** srcs, const int* shs, const int* sws,
                        int n, int c, int dh, int dw,
                        float scale, float offset,
                        uint8_t* scratch, float* dst) {
    const int64_t frame = static_cast<int64_t>(dh) * dw * c;
    for (int i = 0; i < n; ++i) {
        const uint8_t* frame_src = srcs[i];
        if (shs[i] != dh || sws[i] != dw) {
            resize_bilinear_u8(srcs[i], shs[i], sws[i], c, scratch, dh, dw);
            frame_src = scratch;
        }
        u8_to_normalized_f32(frame_src, dst + i * frame, frame, scale, offset);
    }
}

int fastops_abi_version() { return 1; }

}  // extern "C"
