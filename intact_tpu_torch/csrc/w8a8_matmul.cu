// W8A8 matrix product, hand-written for Hopper (sm_90a): dynamic int8
// quantization of the activations, an int8 x int8 -> int32 tensor-core product,
// and the fp32 rescale by the activation and weight scales.
//
// Replaces intact_tpu/ops/pallas_int8.py::w8a8_matmul (Pallas kernel
// `_kernel`) and the XLA branch of intact_tpu/models/common.py::_dense_int8.
// For x [M, K] (bf16 or fp32), int8 weights wq [K, N] with fp32
// per-output-channel scales ws [N], and a chunk length C along K:
//   xs[m, c]  = max(max_{k in chunk c} |x[m, k]|, 1e-6) * fl(1/127)
//   xq[m, k]  = round_half_even(x[m, k] / xs[m, c])            (int8)
//   acc[m, n] = fma(float(sum_{k in c} xq[m, k] * wq[k, n]), xs[m, c], acc[m, n])
//               over the chunks c in order, from acc = 0
//   y[m, n]   = acc * ws[n], or fma(acc, ws[n], bias[n]) with a bias; cast
// The chunk is the whole K for _dense_int8's per-row semantics and
// min(2048, round_up(K, 128)) for the Pallas kernel's per-(row, chunk) ones;
// a chunk's int32 sum is exact (|sum| <= 16384 * 127^2 < 2^31). The fp32
// steps are those the reference computes when it runs compiled: XLA turns its
// division by the constant 127 into a multiply by the reciprocal, and
// contracts the chunk fold and the bias add into fused multiply-adds. x / xs
// stays an IEEE division. Each step is written with its intrinsic
// (__fdiv_rn, __fmul_rn, __fmaf_rn), so nvcc contracts nothing else.
//
// What bounds it: operations. At the Gemma-2B up projection of a batch-64
// prefill (M 20992, K 2048, N 16384) the product is 1.41e12 int8 operations,
// 0.71 ms at the H100's 1979 TOPS, against 0.81 GB of bytes (x, w, y) that
// take 0.24 ms at 3.35 TB/s. The expert's decode products (M 5 or 320) move
// their weights once and are bound by bytes.
//
// Design. Two launches:
//  1. quantize: one block per (row, chunk) reduces the chunk's absmax, then
//     writes its int8 codes into xq [M, K_pad] (K_pad = round_up(K, 64),
//     zero-filled past K) and its scale into xs [M, n_chunks]. x is read twice
//     (absmax, then codes) and xq written once: the activations are quantized
//     once per row, not once per N-block as on the TPU.
//  2. product: a 128 x 128 output tile per block of 8 warps (2 x 4, each warp
//     64 x 32), K walked in steps of 64 with two smem stages. xq tiles arrive
//     by cp.async; weight tiles are read from the [K, N] layout in 8-byte
//     pieces of 4 rows (a row's 128 bytes by 16 threads), transposed in
//     registers (__byte_perm) into k-contiguous words and stored as [n][k]
//     under an XOR swizzle, so the tensor-core operand B needs no transposed
//     copy of the weights. mma.sync m16n8k32 s8 accumulates int32 in registers; at
//     each chunk end the int32 sums fold into fp32 accumulators with the row's
//     scale (acc = fma(float(int), xs, acc)), then reset. The epilogue
//     multiplies by ws (fused with the fp32 bias), casts and stores, masking
//     the ragged M and N edges; rows past M load a valid row and are never
//     stored.
// Not yet done: wgmma and TMA, fusing the quantize pass into the product,
// and split-K for the small-M decode products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;
constexpr int kStride = kBK + 16;  // smem row stride in bytes: conflict-free fragment loads
constexpr int kThreads = 256;
constexpr int kQuantThreads = 256;
constexpr float kInv127 = 1.0f / 127.0f;

__device__ __forceinline__ float load_f(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) { return __bfloat162float(p[i]); }

__device__ __forceinline__ void store_f(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, size_t i, float v) { p[i] = __float2bfloat16_rn(v); }

// max that propagates NaN, as jnp.max does
__device__ __forceinline__ float nan_max(float a, float b) { return (a != a || a > b) ? a : b; }

template <typename T>
__global__ void __launch_bounds__(kQuantThreads) quantize_kernel(
    const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ xs,
    int K, int K_pad, int chunk, int n_chunks) {
  const int c = blockIdx.x % n_chunks;
  const size_t row = blockIdx.x / n_chunks;
  const int k0 = c * chunk;
  const int k_end = min(k0 + chunk, K);
  const int q_end = min(k0 + chunk, K_pad);
  const T* xr = x + row * K;

  float m = 0.0f;
  for (int k = k0 + threadIdx.x; k < k_end; k += kQuantThreads) m = nan_max(m, fabsf(load_f(xr, k)));
  for (int o = 16; o > 0; o >>= 1) m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float warp_max[kQuantThreads / 32];
  __shared__ float scale;
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = warp_max[0];
    for (int w = 1; w < kQuantThreads / 32; ++w) t = nan_max(t, warp_max[w]);
    t = (t != t) ? t : fmaxf(t, 1e-6f);  // jnp.maximum(amax, 1e-6) keeps a NaN
    scale = __fmul_rn(t, kInv127);
    xs[row * n_chunks + c] = scale;
  }
  __syncthreads();
  const float s = scale;
  int8_t* qr = xq + row * K_pad;
  for (int k = k0 + threadIdx.x; k < q_end; k += kQuantThreads) {
    int q = k < K ? __float2int_rn(__fdiv_rn(load_f(xr, k), s)) : 0;  // round half to even
    qr[k] = (int8_t)q;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One thread's share of a weight tile: rows k0..k0+3, columns n0..n0+7 of wq [K, N].
struct WPiece {
  uint2 r[4];
};

__device__ __forceinline__ WPiece load_wpiece(const int8_t* __restrict__ wq, int K, int N, int k0, int n0,
                                              bool aligned8) {
  WPiece b;
  if (aligned8 && k0 + 3 < K && n0 + 7 < N) {
#pragma unroll
    for (int i = 0; i < 4; ++i) b.r[i] = __ldg(reinterpret_cast<const uint2*>(wq + (size_t)(k0 + i) * N + n0));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t w[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        int k = k0 + i, n = n0 + j;
        uint32_t v = (k < K && n < N) ? (uint32_t)(uint8_t)wq[(size_t)k * N + n] : 0u;
        w[j >> 2] |= v << (8 * (j & 3));
      }
      b.r[i] = make_uint2(w[0], w[1]);
    }
  }
  return b;
}

// Bs holds the weight tile as [n][k]: row n is 16 words of 4 k-consecutive
// bytes, word kw stored at position kw ^ swz(n). The swizzle makes both the
// transposed stores (2-way) and the mma fragment loads (conflict-free) cheap.
__device__ __forceinline__ int swz(int n) { return ((n >> 3) ^ ((n >> 1) << 2)) & 15; }

__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3, uint32_t* w) {
  uint32_t t0 = __byte_perm(r0, r1, 0x5140);
  uint32_t t1 = __byte_perm(r2, r3, 0x5140);
  uint32_t t2 = __byte_perm(r0, r1, 0x7362);
  uint32_t t3 = __byte_perm(r2, r3, 0x7362);
  w[0] = __byte_perm(t0, t1, 0x5410);  // column 0: bytes of rows 0..3
  w[1] = __byte_perm(t0, t1, 0x7632);
  w[2] = __byte_perm(t2, t3, 0x5410);
  w[3] = __byte_perm(t2, t3, 0x7632);
}

// Store the piece's 8 columns as k-contiguous words: column j lands in Bs row
// nl + j, word kw.
__device__ __forceinline__ void store_wpiece(uint32_t* bs, const WPiece& b, int kw, int nl) {
  uint32_t w[8];
  transpose4(b.r[0].x, b.r[1].x, b.r[2].x, b.r[3].x, w);
  transpose4(b.r[0].y, b.r[1].y, b.r[2].y, b.r[3].y, w + 4);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    int n = nl + j;
    bs[n * (kBK / 4) + (kw ^ swz(n))] = w[j];
  }
}

template <typename TO>
__global__ void __launch_bounds__(kThreads, 1) gemm_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ xs, const int8_t* __restrict__ wq,
    const float* __restrict__ ws, const float* __restrict__ bias, TO* __restrict__ out,
    int M, int K, int N, int K_pad, int chunk, int n_chunks, int aligned8) {
  __shared__ __align__(16) int8_t As[2][kBM * kStride];
  __shared__ __align__(16) uint32_t Bs[2][kBN * (kBK / 4)];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows wm*64.., columns wn*32..
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int n_kt = K_pad / kBK;
  // this thread's weight piece of every tile: k-word wkw (rows 4*wkw..+3), columns wnl..wnl+7
  const int wkw = tid >> 4, wnl = (tid & 15) * 8;

  int acc[4][4][4];
  float accf[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0;
        accf[i][j][e] = 0.0f;
      }

  auto load_a = [&](int stage, int kt) {
#pragma unroll
    for (int i = 0; i < (kBM * kBK / 16) / kThreads; ++i) {
      int idx = tid + i * kThreads;
      int r = idx >> 2, c16 = idx & 3;
      int gr = min(m0 + r, M - 1);  // rows past M load a valid row; never stored
      cp_async16(&As[stage][r * kStride + c16 * 16], xq + (size_t)gr * K_pad + kt * kBK + c16 * 16);
    }
    cp_async_commit();
  };

  load_a(0, 0);
  WPiece piece = load_wpiece(wq, K, N, 4 * wkw, n0 + wnl, aligned8 != 0);
  store_wpiece(Bs[0], piece, wkw, wnl);
  cp_async_wait_all();
  __syncthreads();

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    const bool more = kt + 1 < n_kt;
    if (more) {  // next tile in flight while this one computes
      load_a(st ^ 1, kt + 1);
      piece = load_wpiece(wq, K, N, (kt + 1) * kBK + 4 * wkw, n0 + wnl, aligned8 != 0);
    }
    const int8_t* as = As[st];
    const uint32_t* bs = Bs[st];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* p = as + (wm * 64 + mi * 16 + g) * kStride + kk + tig * 4;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kStride);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kStride + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn * 32 + ni * 8 + g;
        const int kw = kk / 4 + tig;
        bf[ni][0] = bs[n * (kBK / 4) + (kw ^ swz(n))];
        bf[ni][1] = bs[n * (kBK / 4) + ((kw + 4) ^ swz(n))];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    const int k_next = (kt + 1) * kBK;
    if (!more || k_next % chunk == 0) {
      // chunk end: accf = fma(float(acc), xs[row, chunk], accf), acc = 0, for
      // this thread's rows m0 + wm*64 + mi*16 + g + 8h
      const int chunk_idx = (k_next - 1) / chunk;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = min(m0 + wm * 64 + mi * 16 + g + 8 * h, M - 1);
          const float s = xs[(size_t)r * n_chunks + chunk_idx];
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              accf[mi][ni][2 * h + e] = __fmaf_rn(__int2float_rn(acc[mi][ni][2 * h + e]), s, accf[mi][ni][2 * h + e]);
              acc[mi][ni][2 * h + e] = 0;
            }
        }
    }
    if (more) store_wpiece(Bs[st ^ 1], piece, wkw, wnl);
    cp_async_wait_all();
    __syncthreads();
  }

  // epilogue: y = acc * ws, or fma(acc, ws, bias); cast, masked store
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n0 + wn * 32 + ni * 8 + tig * 2 + e;
      if (col >= N) continue;
      const float w = ws[col];
      const float b = bias != nullptr ? bias[col] : 0.0f;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm * 64 + mi * 16 + g + 8 * h;
          if (row >= M) continue;
          const float a = accf[mi][ni][2 * h + e];
          const float y = bias != nullptr ? __fmaf_rn(a, w, b) : __fmul_rn(a, w);
          store_f(out, (size_t)row * N + col, y);
        }
    }
}

template <typename TI, typename TO>
cudaError_t launch(const void* x, const int8_t* wq, const float* ws, const float* bias, void* out, int8_t* xq,
                   float* xs, int M, int K, int N, int K_pad, int chunk, int n_chunks, int aligned8,
                   cudaStream_t stream) {
  quantize_kernel<TI><<<M * n_chunks, kQuantThreads, 0, stream>>>(static_cast<const TI*>(x), xq, xs, K,
                                                                          K_pad, chunk, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_kernel<TO><<<grid, kThreads, 0, stream>>>(xq, xs, wq, ws, bias, static_cast<TO*>(out), M, K, N, K_pad,
                                                 chunk, n_chunks, aligned8);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [M, K] bf16 (x_bf16 != 0) or fp32; wq [K, N] int8; ws [N] fp32; bias [N]
// fp32 or null; out [M, N] bf16 (out_bf16 != 0) or fp32; scratch xq [M, K_pad]
// int8 and xs [M, n_chunks] fp32. K_pad = round_up(K, 64); chunk is a
// multiple of 64 (K_pad for the per-row semantics); n_chunks = ceil(K / chunk).
// aligned8: wq's pointer and N are multiples of 8 (8-byte weight loads).
// Returns a cudaError_t (0 = launched).
int intact_w8a8_matmul(const void* x, int x_bf16, const void* wq, const void* ws, const void* bias, void* out,
                       int out_bf16, void* xq, void* xs, int M, int K, int N, int K_pad, int chunk,
                       int n_chunks, int aligned8, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  if (K_pad % kBK || chunk % kBK || K_pad < K) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<const int8_t*>(wq);
  auto sc = static_cast<const float*>(ws);
  auto b = static_cast<const float*>(bias);
  auto q = static_cast<int8_t*>(xq);
  auto f = static_cast<float*>(xs);
  cudaError_t err;
  if (x_bf16 && out_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, w, sc, b, out, q, f, M, K, N, K_pad, chunk, n_chunks, aligned8, s);
  else if (x_bf16)
    err = launch<__nv_bfloat16, float>(x, w, sc, b, out, q, f, M, K, N, K_pad, chunk, n_chunks, aligned8, s);
  else if (out_bf16)
    err = launch<float, __nv_bfloat16>(x, w, sc, b, out, q, f, M, K, N, K_pad, chunk, n_chunks, aligned8, s);
  else
    err = launch<float, float>(x, w, sc, b, out, q, f, M, K, N, K_pad, chunk, n_chunks, aligned8, s);
  return (int)err;
}

const char* intact_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
