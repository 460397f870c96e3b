// W8A8 matrix product, hand-written for Hopper (sm_90a): dynamic int8
// quantization of the activations, an int8 x int8 -> int32 tensor-core product
// (wgmma), and the fp32 rescale by the activation and weight scales.
//
// Replaces intact_tpu/ops/pallas_int8.py::w8a8_matmul (Pallas kernel
// `_kernel`) and the XLA branch of intact_tpu/models/common.py::_dense_int8.
// For x [M, K] (bf16 or fp32), int8 weight codes w with fp32 per-output-channel
// scales ws [N], and a chunk length C along K:
//   xs[m, c]  = max(max_{k in chunk c} |x[m, k]|, 1e-6) * fl(1/127)
//   xq[m, k]  = round_half_even(x[m, k] / xs[m, c])            (int8)
//   acc[m, n] = fma(float(sum_{k in c} xq[m, k] * w[k, n]), xs[m, c], acc[m, n])
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
// The weights come K-major, as codes [N, K] with a row stride of a multiple
// of 16 bytes: wgmma reads 8-bit operands K-major only (its transpose bits
// exist for 16-bit types), and TMA takes 16-byte strides only.
//
// What bounds it: operations for the prefill products, bytes for the
// expert's. At the Gemma-2B up projection of a batch-64 prefill (M 20992,
// K 2048, N 16384) the product is 1.41e12 int8 operations, 0.71 ms at the
// H100's 1979 TOPS, against 0.81 GB of bytes (x, w, y) that take 0.24 ms at
// 3.35 TB/s. The expert's decode products (M 5 or 320, K 1024 or 4096) move
// 1-4 MB of weights once: 0.6-2.2 us.
//
// Design:
//  1. quantize: one block per (row, chunk) reduces the chunk's absmax, then
//     writes its int8 codes into xq [M, K_pad] (K_pad = round_up(K, 64),
//     zero-filled past K) and its scale into xs [M, n_chunks]; 16-byte loads
//     and 8- or 4-byte code stores where the row alignment allows. x is read
//     twice (the second time mostly from L2).
//  2. product, warp-specialised, one block of three warpgroups per SM: a
//     producer warpgroup keeps 4 stages of A (xq) and B (weight) tiles of 128
//     K-bytes in flight by TMA (128-byte swizzle, zeros past M, N and K) in an
//     mbarrier ring; two consumer warpgroups each run wgmma m64nNk32
//     s8.s8.s32 on 64 rows with int32 accumulators in registers.
//     - mode row (per-row semantics, many output tiles): 128 x 256 tiles, one
//       wgmma group kept in flight across stages; one fold at the end,
//       fma(float(acc), xs, 0), then the ws/bias epilogue.
//     - mode chunk (per-chunk semantics, many output tiles): 128 x 128 tiles;
//       at each chunk end (chunks are multiples of 64, so mid-stage ends
//       happen) the int32 sums fold into fp32 registers with the row's scale
//       and restart.
//     - mode split (few output tiles: the expert's M = 5 and 320 products):
//       K is split across blocks so the weights stream through the whole card;
//       each block adds its int32 sums per chunk into an int32 workspace
//       [n_chunks, M, N] (zeroed by the quantize pass) with atomics (integer
//       addition is exact and order-free, so the result is bit-equal to the
//       plain version); a finish pass folds the chunks in order and applies
//       the epilogue. In per-chunk semantics the splits hold whole chunks.
//     Output tiles are walked in groups of 16 M-tiles so that the blocks in
//     flight share their A and B tiles in L2; ws, bias and xs of a tile are
//     fetched into shared memory and registers before the main loop.
//     The mode and the split come from ops/w8a8.py::plan, from the shape.
//  The epilogue multiplies by ws with the same intrinsics as before and,
//  where out's rows are 16-byte aligned, stages the tile in shared memory and
//  writes it with TMA stores (which clip the ragged M and N edges); else it
//  stores pairs of outputs from registers, masking the edges.
//
// The row-parallel entries (tensor parallelism: each rank holds K / t of the
// product's input rows, per-row semantics): intact_w8a8_partial quantizes x
// against a row absmax given from outside (the whole row's, a MAX all-reduce
// over the ranks), then runs the split mode's product and leaves its exact
// int32 partial sums [M, N] in `part` (no finish pass; where one block holds
// the whole K, n_splits 1, it stores them, with no zeroing and no atomics,
// else the blocks add them into the zeroed workspace); the caller sums the
// ranks' partials, and intact_w8a8_finish runs the finish pass on the sum.
// Integer sums are exact, so the product is bit-equal to one card's.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBM = 128;      // rows per block: two consumer warpgroups of 64
constexpr int kBK = 128;      // K bytes per stage: one 128-byte swizzled row
constexpr int kStages = 4;
constexpr int kThreads = 384;
constexpr int kQuantThreads = 256;
constexpr int kFinishThreads = 256;
constexpr int kGroupM = 16;   // output tiles are walked in groups of 16 M-tiles, so the blocks in flight share A and B tiles in L2
constexpr float kInv127 = 1.0f / 127.0f;

enum Mode { kRow = 0, kChunk = 1, kSplit = 2 };

template <int kMode>
struct Cfg {
  static constexpr int BN = kMode == kRow ? 256 : 128;
  static constexpr int kA = kBM * kBK;  // bytes of a stage's A tile
  static constexpr int kB = BN * kBK;   // ... and of its B tile
  static constexpr int kStage = kA + kB;
  static constexpr int bar = kStages * kStage;
  static constexpr int epi = bar + 16 * kStages;  // each consumer warpgroup's ws and bias of the tile's columns
  static constexpr int bytes = epi + 2 * 2 * BN * 4 + 1024;  // + slack to align the base to 1024
};

__device__ __forceinline__ float load_f(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) { return __bfloat162float(p[i]); }

__device__ __forceinline__ void store_f(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, size_t i, float v) { p[i] = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_f2(float* p, size_t i, float a, float b) {
  *reinterpret_cast<float2*>(p + i) = make_float2(a, b);
}
__device__ __forceinline__ void store_f2(__nv_bfloat16* p, size_t i, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p + i) = __floats2bfloat162_rn(a, b);
}

// max that propagates NaN, as jnp.max does
__device__ __forceinline__ float nan_max(float a, float b) { return (a != a || a > b) ? a : b; }

template <typename T>
__global__ void __launch_bounds__(kQuantThreads) quantize_kernel(
    const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ xs,
    int K, int K_pad, int chunk, int n_chunks, int* __restrict__ part, size_t part_len,
    const float* __restrict__ amax_in) {
  // the split mode's int32 workspace starts at 0 (the product runs after this pass)
  for (size_t i = (size_t)blockIdx.x * kQuantThreads + threadIdx.x; i < part_len; i += (size_t)gridDim.x * kQuantThreads)
    part[i] = 0;
  const int c = blockIdx.x % n_chunks;
  const size_t row = blockIdx.x / n_chunks;
  const int k0 = c * chunk;
  const int k_end = min(k0 + chunk, K);
  const int q_end = min(k0 + chunk, K_pad);
  const T* xr = x + row * K;
  // 16-byte groups of V values where every row starts 16-byte aligned; a
  // group never straddles a chunk (chunks are multiples of 64) or K
  constexpr int V = 16 / sizeof(T);
  const bool vec = K % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;

  float m = 0.0f;
  if (amax_in != nullptr) {
    // the row's absmax comes from outside (one chunk per row): no reduction here
  } else if (vec) {
    for (int k = k0 + threadIdx.x * V; k < k_end; k += kQuantThreads * V) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(xr + k));
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < V; ++e) m = nan_max(m, fabsf(load_f(v, e)));
    }
  } else {
    for (int k = k0 + threadIdx.x; k < k_end; k += kQuantThreads) m = nan_max(m, fabsf(load_f(xr, k)));
  }
  for (int o = 16; o > 0; o >>= 1) m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float warp_max[kQuantThreads / 32];
  __shared__ float scale;
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = warp_max[0];
    for (int w = 1; w < kQuantThreads / 32; ++w) t = nan_max(t, warp_max[w]);
    if (amax_in != nullptr) t = amax_in[row];
    t = (t != t) ? t : fmaxf(t, 1e-6f);  // jnp.maximum(amax, 1e-6) keeps a NaN
    scale = __fmul_rn(t, kInv127);
    xs[row * n_chunks + c] = scale;
  }
  __syncthreads();
  const float s = scale;
  int8_t* qr = xq + row * K_pad;
  if (vec) {  // V codes per store (K_pad is a multiple of 64, so the stores are aligned)
    for (int k = k0 + threadIdx.x * V; k < q_end; k += kQuantThreads * V) {
      uint32_t w[V / 4] = {};
      if (k < K) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(xr + k));
        const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < V; ++e)  // round half to even
          w[e / 4] |= (uint32_t)(uint8_t)__float2int_rn(__fdiv_rn(load_f(v, e), s)) << (8 * (e % 4));
      }
      if constexpr (V == 8) *reinterpret_cast<uint2*>(qr + k) = make_uint2(w[0], w[1]);
      else *reinterpret_cast<uint32_t*>(qr + k) = w[0];
    }
  } else {
    for (int k = k0 + threadIdx.x; k < q_end; k += kQuantThreads) {
      int q = k < K ? __float2int_rn(__fdiv_rn(load_f(xr, k), s)) : 0;  // round half to even
      qr[k] = (int8_t)q;
    }
  }
}

#define S32_REGS_128 "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "\
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "\
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "\
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "\
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "\
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "\
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "\
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
#define S32_ACC_128(d) \
      "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),  \
      "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),  \
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),  \
      "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),  \
      "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),  \
      "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),  \
      "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),  \
      "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),  \
      "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),  \
      "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),  \
      "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),  \
      "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),  \
      "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),  \
      "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),  \
      "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),  \
      "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " S32_REGS_128 ", %128, %129, p;\n"
      "}\n"
      : S32_ACC_128(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

#define S32_REGS_64 "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "\
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "\
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "\
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define S32_ACC_64(d) \
      "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),  \
      "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),  \
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),  \
      "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),  \
      "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),  \
      "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),  \
      "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),  \
      "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " S32_REGS_64 ", %64, %65, p;\n"
      "}\n"
      : S32_ACC_64(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A B over one k32 step: A [64 x 32] and B [32 x BN] int8, both K-major in shared memory
template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t da, uint64_t db, int accumulate) {
  if constexpr (BN == 256) wgmma_s8_n256(d, da, db, accumulate);
  else wgmma_s8_n128(d, da, db, accumulate);
}

template <int kMode, typename TO>
__global__ void __launch_bounds__(kThreads, 1) gemm_kernel(
    const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
    const __grid_constant__ CUtensorMap omap, const float* __restrict__ xs, const float* __restrict__ ws,
    const float* __restrict__ bias, TO* __restrict__ out, int* __restrict__ part, int M, int N, int K_pad, int chunk,
    int n_chunks, int split_len, int vec2, int tma_out) {
  using C = Cfg<kMode>;
  constexpr int BN = C::BN;
  constexpr int kAcc = BN / 2;  // accumulators per thread: 64 rows x BN over 128 threads

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t bars = smem_u32(smem + C::bar);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };

  // output tile of this block: grouped order along M (see kGroupM)
  const int tiles_n = (N + BN - 1) / BN, tiles_m = (M + kBM - 1) / kBM;
  const int per_group = kGroupM * tiles_n;
  const int first_m = (blockIdx.x / per_group) * kGroupM;
  const int group_m = min(tiles_m - first_m, kGroupM);
  const int n0 = ((blockIdx.x % per_group) / group_m) * BN;
  const int m0 = (first_m + (blockIdx.x % per_group) % group_m) * kBM;
  const int k_begin = blockIdx.z * split_len;
  const int k_end = min(k_begin + split_len, K_pad);
  const int n_kt = (k_end - k_begin + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------- producer warpgroup: one thread issues the TMA loads ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        mbar_wait(empty(s), ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), C::kStage);
        const int k = k_begin + kt * kBK;
        tma_load_2d(smem_u32(smem + s * C::kStage), &amap, full(s), k, m0);
        tma_load_2d(smem_u32(smem + s * C::kStage + C::kA), &bmap, full(s), k, n0);
      }
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int r0 = warp * 16 + lane / 4;  // rows r0 and r0 + 8 of the warpgroup's 64
    const int c0 = 2 * (lane % 4);        // columns c0, c0 + 1 of every 8
    const int row_base = m0 + wg * 64;
    const bool active = row_base < M;

    // the epilogue's per-column ws and bias, and per-row xs, fetched before
    // the main loop so their latency hides behind it
    float* ws_s = reinterpret_cast<float*>(smem + C::epi) + wg * 2 * BN;
    float* b_s = ws_s + BN;
    float sx[2] = {0.0f, 0.0f};
    if constexpr (kMode != kSplit) {
      for (int i = tid; i < BN; i += 128) {
        const int col = min(n0 + i, N - 1);
        ws_s[i] = ws[col];
        b_s[i] = bias != nullptr ? bias[col] : 0.0f;
      }
      if constexpr (kMode == kRow) {
#pragma unroll
        for (int h = 0; h < 2; ++h) sx[h] = xs[min(row_base + r0 + 8 * h, M - 1)];
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this warpgroup's 128 threads
    }

    // accumulator element 4j + 2h + e: row row_base + r0 + 8h, column n0 + 8j + c0 + e
    int acc[kAcc];
    float accf[kMode == kChunk ? kAcc : 1];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0;
#pragma unroll
    for (int i = 0; i < (kMode == kChunk ? kAcc : 1); ++i) accf[i] = 0.0f;

    // chunk c's int32 sums are complete: fold them (chunk) or add them to the workspace (split)
    auto flush = [&](int c) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row_base + r0 + 8 * h;
        if constexpr (kMode == kChunk) {
          const float sx = xs[(size_t)min(row, M - 1) * n_chunks + c];
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * h + e;
              accf[i] = __fmaf_rn(__int2float_rn(acc[i]), sx, accf[i]);
            }
        } else {
          if (row < M) {
#pragma unroll
            for (int j = 0; j < BN / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int col = n0 + 8 * j + c0 + e;
                if (col >= N) continue;
                int* dst = part + ((size_t)c * M + row) * N + col;
                if (gridDim.z == 1)
                  *dst = acc[4 * j + 2 * h + e];  // one block holds the whole K: the only write
                else
                  atomicAdd(dst, acc[4 * j + 2 * h + e]);
              }
          }
        }
      }
    };

    bool fresh = true;  // the next wgmma starts the int32 sums from 0
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % kStages;
      mbar_wait(full(s), (kt / kStages) & 1);
      if (!active) {
        mbar_arrive(empty(s));
        continue;
      }
      const uint32_t a_base = smem_u32(smem + s * C::kStage + wg * 64 * kBK);
      const uint32_t b_base = smem_u32(smem + s * C::kStage + C::kA);
      if constexpr (kMode == kRow) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk)
          wgmma_s8<BN>(acc, desc_sw128(a_base + kk * 32, 16, 1024), desc_sw128(b_base + kk * 32, 16, 1024),
                       !(fresh && kk == 0));
        fresh = false;
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: release it
        if (kt > 0) mbar_arrive(empty((kt - 1) % kStages));
      } else {
        // two halves of 64 K-bytes: a chunk may end after either
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          wgmma_fence();
#pragma unroll
          for (int kk = 2 * half; kk < 2 * half + 2; ++kk)
            wgmma_s8<BN>(acc, desc_sw128(a_base + kk * 32, 16, 1024), desc_sw128(b_base + kk * 32, 16, 1024),
                         !(fresh && kk == 2 * half));
          fresh = false;
          wgmma_commit();
          const int pe = k_begin + kt * kBK + (half + 1) * 64;
          const bool last = pe >= k_end;
          if (last || pe % chunk == 0) {
            wgmma_wait<0>();
#pragma unroll
            for (int i = 0; i < kAcc; ++i) fence_operand(acc[i]);
            flush((pe - 1) / chunk);
            fresh = true;
          }
          if (last) break;
        }
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < kAcc; ++i) fence_operand(acc[i]);
        mbar_arrive(empty(s));
      }
    }
    if constexpr (kMode == kRow) {
      if (active) {
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < kAcc; ++i) fence_operand(acc[i]);
        if (n_kt > 0) mbar_arrive(empty((n_kt - 1) % kStages));
      }
    }

    if constexpr (kMode != kSplit) {
      // epilogue: y = acc * ws, or fma(acc, ws, bias), cast. Where out's rows
      // are 16-byte aligned, each warpgroup writes its 64 x BN tile into the
      // stage buffers (free once both warpgroups are past the main loop) as
      // 128-byte swizzled boxes of E columns, and TMA stores them (clipping
      // rows past M and columns past N); else masked stores from registers.
      constexpr int E = 128 / sizeof(TO);
      uint8_t* ot = smem + wg * (64 * BN * sizeof(TO));
      if (tma_out) asm volatile("bar.sync 3, 256;\n" ::: "memory");
      if (active) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = n0 + 8 * j + c0;
          const bool pair = col + 1 < N;
          const float w0 = ws_s[8 * j + c0], w1 = ws_s[8 * j + c0 + 1];
          const float b0 = b_s[8 * j + c0], b1 = b_s[8 * j + c0 + 1];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row_base + r0 + 8 * h;
            float a[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * h + e;
              a[e] = kMode == kRow ? __fmaf_rn(__int2float_rn(acc[i]), sx[h], 0.0f) : accf[i];
            }
            const float y0 = bias != nullptr ? __fmaf_rn(a[0], w0, b0) : __fmul_rn(a[0], w0);
            const float y1 = bias != nullptr ? __fmaf_rn(a[1], w1, b1) : __fmul_rn(a[1], w1);
            if (tma_out) {
              const int r = r0 + 8 * h, tc = 8 * j + c0;  // row and column in the warpgroup's tile
              const int off = (tc % E) * (int)sizeof(TO);
              store_f2(reinterpret_cast<TO*>(ot + (tc / E) * 8192 + r * 128 + (((off / 16) ^ (r & 7)) * 16) + off % 16),
                       0, y0, y1);
              continue;
            }
            if (row >= M || col >= N) continue;
            const size_t o = (size_t)row * N + col;
            if (pair && vec2) {
              store_f2(out, o, y0, y1);
            } else {
              store_f(out, o, y0);
              if (pair) store_f(out, o + 1, y1);
            }
          }
        }
      }
      if (tma_out) {
        fence_async_shared();
        asm volatile("bar.sync %0, 128;\n" ::"r"(4 + wg) : "memory");  // this warpgroup's tile is written
        if (tid == 0 && active) {
          for (int box = 0; box < BN / E; ++box) tma_store_2d(&omap, smem_u32(ot + box * 8192), n0 + box * E, row_base);
          bulk_commit();
          bulk_wait_read();  // the stores have read the tile; they complete on their own
        }
      }
    }
  }
}

// split mode's second pass: fold the int32 chunk sums in chunk order
// (acc = fma(float(sum), xs, acc) from 0), epilogue
template <typename TO>
__global__ void __launch_bounds__(kFinishThreads) finish_kernel(
    const int* __restrict__ part, const float* __restrict__ xs, const float* __restrict__ ws,
    const float* __restrict__ bias, TO* __restrict__ out, int M, int N, int n_chunks) {
  const size_t i = (size_t)blockIdx.x * kFinishThreads + threadIdx.x;
  if (i >= (size_t)M * N) return;
  const int m = (int)(i / N), n = (int)(i % N);
  float acc = 0.0f;
  for (int c = 0; c < n_chunks; ++c)
    acc = __fmaf_rn(__int2float_rn(part[((size_t)c * M + m) * N + n]), xs[(size_t)m * n_chunks + c], acc);
  store_f(out, i, bias != nullptr ? __fmaf_rn(acc, ws[n], bias[n]) : __fmul_rn(acc, ws[n]));
}

template <int kMode, typename TO>
cudaError_t launch_gemm(const CUtensorMap& amap, const CUtensorMap& bmap, const CUtensorMap& omap, int tma_out,
                        const float* xs, const float* ws, const float* bias, TO* out, int* part, int M, int N,
                        int K_pad, int chunk, int n_chunks, int split_len, int n_splits, cudaStream_t stream) {
  using C = Cfg<kMode>;
  auto kern = gemm_kernel<kMode, TO>;
  static bool attribute_set = false;  // once per instantiation (and device: the port runs on one)
  if (!attribute_set) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::bytes);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  const int vec2 = N % 2 == 0;
  dim3 grid(((N + C::BN - 1) / C::BN) * ((M + kBM - 1) / kBM), 1, n_splits);
  kern<<<grid, kThreads, C::bytes, stream>>>(amap, bmap, omap, xs, ws, bias, out, part, M, N, K_pad, chunk,
                                            n_chunks, split_len, vec2, tma_out);
  return cudaGetLastError();
}

template <typename TI, typename TO>
cudaError_t launch(const void* x, const int8_t* wk, long long w_stride, const float* ws, const float* bias, void* out_,
                   int8_t* xq, float* xs, int* part, int M, int K, int N, int K_pad, int chunk, int n_chunks,
                   int mode, int split_len, int n_splits, cudaStream_t stream) {
  TO* out = static_cast<TO*>(out_);
  const size_t part_len = mode == kSplit ? (size_t)n_chunks * M * N : 0;  // the split mode's workspace
  quantize_kernel<TI><<<M * n_chunks, kQuantThreads, 0, stream>>>(static_cast<const TI*>(x), xq, xs, K, K_pad,
                                                                  chunk, n_chunks, part, part_len, nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // A: xq [M, K_pad]; B: the codes [N, K] with row stride w_stride; boxes of
  // 128 K-bytes by 128 rows (A) or BN rows (B)
  CUtensorMap amap, bmap, omap = {};
  const cuuint64_t a_dims[2] = {(cuuint64_t)K_pad, (cuuint64_t)M};
  const cuuint64_t a_strides[1] = {(cuuint64_t)K_pad};
  const cuuint32_t a_box[2] = {kBK, kBM};
  const cuuint64_t b_dims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t b_strides[1] = {(cuuint64_t)w_stride};
  const cuuint32_t b_box[2] = {kBK, (cuuint32_t)(mode == kRow ? Cfg<kRow>::BN : Cfg<kChunk>::BN)};
  const auto ty = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!make_map(&amap, ty, 2, xq, a_dims, a_strides, a_box, sw) ||
      !make_map(&bmap, ty, 2, wk, b_dims, b_strides, b_box, sw))
    return cudaErrorInvalidValue;
  // out [M, N] as boxes of 128 bytes by 64 rows, where its rows are 16-byte aligned
  const int tma_out = mode != kSplit && (size_t)N * sizeof(TO) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (tma_out) {
    const cuuint64_t o_dims[2] = {(cuuint64_t)N, (cuuint64_t)M};
    const cuuint64_t o_strides[1] = {(cuuint64_t)N * sizeof(TO)};
    const cuuint32_t o_box[2] = {128 / sizeof(TO), 64};
    const auto oty = sizeof(TO) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    if (!make_map(&omap, oty, 2, out, o_dims, o_strides, o_box, sw)) return cudaErrorInvalidValue;
  }
  switch (mode) {
    case kRow:
      return launch_gemm<kRow, TO>(amap, bmap, omap, tma_out, xs, ws, bias, out, part, M, N, K_pad, chunk, n_chunks,
                                   K_pad, 1, stream);
    case kChunk:
      return launch_gemm<kChunk, TO>(amap, bmap, omap, tma_out, xs, ws, bias, out, part, M, N, K_pad, chunk,
                                     n_chunks, K_pad, 1, stream);
    case kSplit: {
      err = launch_gemm<kSplit, TO>(amap, bmap, omap, 0, xs, ws, bias, out, part, M, N, K_pad, chunk, n_chunks,
                                    split_len, n_splits, stream);
      if (err != cudaSuccess) return err;
      const size_t total = (size_t)M * N;
      finish_kernel<TO><<<(unsigned)((total + kFinishThreads - 1) / kFinishThreads), kFinishThreads, 0, stream>>>(
          part, xs, ws, bias, out, M, N, n_chunks);
      return cudaGetLastError();
    }
    default:
      return cudaErrorInvalidValue;
  }
}

// the row-parallel product: quantize against the given row absmax, then the
// split mode's product into the zeroed int32 workspace part [M, N]
template <typename TI>
cudaError_t launch_partial(const void* x, const int8_t* wk, long long w_stride, const float* amax, int8_t* xq,
                           float* xs, int* part, int M, int K, int N, int K_pad, int split_len, int n_splits,
                           cudaStream_t stream) {
  // one split stores its sums (no zeroing); several add theirs into the zeroed workspace
  quantize_kernel<TI><<<M, kQuantThreads, 0, stream>>>(static_cast<const TI*>(x), xq, xs, K, K_pad, K_pad, 1, part,
                                                       n_splits == 1 ? 0 : (size_t)M * N, amax);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap amap, bmap, omap = {};
  const cuuint64_t a_dims[2] = {(cuuint64_t)K_pad, (cuuint64_t)M};
  const cuuint64_t a_strides[1] = {(cuuint64_t)K_pad};
  const cuuint32_t a_box[2] = {kBK, kBM};
  const cuuint64_t b_dims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t b_strides[1] = {(cuuint64_t)w_stride};
  const cuuint32_t b_box[2] = {kBK, (cuuint32_t)Cfg<kSplit>::BN};
  const auto ty = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!make_map(&amap, ty, 2, xq, a_dims, a_strides, a_box, sw) ||
      !make_map(&bmap, ty, 2, wk, b_dims, b_strides, b_box, sw))
    return cudaErrorInvalidValue;
  return launch_gemm<kSplit, float>(amap, bmap, omap, 0, xs, nullptr, nullptr, nullptr, part, M, N, K_pad, K_pad, 1,
                                    split_len, n_splits, stream);
}

}  // namespace

extern "C" {

// x [M, K] bf16 (x_bf16 != 0) or fp32; wk the int8 codes K-major, [N, K] with
// a row stride of w_stride bytes (a multiple of 16, >= K), 16-byte aligned;
// ws [N] fp32; bias [N] fp32 or null; out [M, N] bf16 (out_bf16 != 0) or fp32;
// scratch xq [M, K_pad] int8 (16-byte aligned) and xs [M, n_chunks] fp32.
// K_pad = round_up(K, 64); chunk is a multiple of 64 (K_pad for the per-row
// semantics); n_chunks = ceil(K / chunk). mode 0 row, 1 chunk, 2 split; in
// split mode part is an int32 workspace [n_chunks, M, N], and blocks take
// split_len K-bytes each (a multiple of 128, and of chunk when chunk < K_pad),
// n_splits of them. Returns a cudaError_t (0 = launched).
int intact_w8a8_matmul(const void* x, int x_bf16, const void* wk, long long w_stride, const void* ws,
                       const void* bias, void* out, int out_bf16, void* xq, void* xs, void* part, int M, int K, int N,
                       int K_pad, int chunk, int n_chunks, int mode, int split_len, int n_splits, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  if (K_pad % 64 || chunk % 64 || K_pad < K || w_stride % 16 || w_stride < K) return (int)cudaErrorInvalidValue;
  if (mode == kSplit && (split_len <= 0 || split_len % kBK || n_splits <= 0 || part == nullptr))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<const int8_t*>(wk);
  auto sc = static_cast<const float*>(ws);
  auto b = static_cast<const float*>(bias);
  auto q = static_cast<int8_t*>(xq);
  auto f = static_cast<float*>(xs);
  auto p = static_cast<int*>(part);
  cudaError_t err;
  if (x_bf16 && out_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, w, w_stride, sc, b, out, q, f, p, M, K, N, K_pad, chunk, n_chunks,
                                               mode, split_len, n_splits, s);
  else if (x_bf16)
    err = launch<__nv_bfloat16, float>(x, w, w_stride, sc, b, out, q, f, p, M, K, N, K_pad, chunk, n_chunks, mode,
                                       split_len, n_splits, s);
  else if (out_bf16)
    err = launch<float, __nv_bfloat16>(x, w, w_stride, sc, b, out, q, f, p, M, K, N, K_pad, chunk, n_chunks, mode,
                                       split_len, n_splits, s);
  else
    err = launch<float, float>(x, w, w_stride, sc, b, out, q, f, p, M, K, N, K_pad, chunk, n_chunks, mode, split_len,
                               n_splits, s);
  return (int)err;
}

// The row-parallel entry's first pass. x [M, K] bf16 (x_bf16 != 0) or fp32; wk
// the int8 codes K-major as for intact_w8a8_matmul; amax [M] fp32, each row's
// absmax over the whole row (all ranks' K); scratch xq [M, K_pad] int8 and
// xs [M] fp32 (the row scales, for the finish pass); part [M, N] int32, the
// exact partial sums of this K (stored at n_splits 1, else zeroed here and
// added into). Split mode: blocks take split_len K-bytes each (a multiple of
// 128), n_splits of them.
int intact_w8a8_partial(const void* x, int x_bf16, const void* wk, long long w_stride, const void* amax, void* xq,
                        void* xs, void* part, int M, int K, int N, int K_pad, int split_len, int n_splits,
                        void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  if (K_pad % 64 || K_pad < K || w_stride % 16 || w_stride < K || split_len <= 0 || split_len % kBK ||
      n_splits <= 0 || amax == nullptr || part == nullptr)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<const int8_t*>(wk);
  auto a = static_cast<const float*>(amax);
  auto q = static_cast<int8_t*>(xq);
  auto f = static_cast<float*>(xs);
  auto p = static_cast<int*>(part);
  cudaError_t err = x_bf16 ? launch_partial<__nv_bfloat16>(x, w, w_stride, a, q, f, p, M, K, N, K_pad, split_len,
                                                           n_splits, s)
                           : launch_partial<float>(x, w, w_stride, a, q, f, p, M, K, N, K_pad, split_len, n_splits, s);
  return (int)err;
}

// The row-parallel entry's finish pass on the ranks' summed partials part
// [M, N] int32 with the row scales xs [M]: acc = fma(float(part), xs, 0), then
// acc * ws or fma(acc, ws, bias), into out [M, N] bf16 (out_bf16 != 0) or fp32.
int intact_w8a8_finish(const void* part, const void* xs, const void* ws, const void* bias, void* out, int out_bf16,
                       int M, int N, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const size_t total = (size_t)M * N;
  const unsigned blocks = (unsigned)((total + kFinishThreads - 1) / kFinishThreads);
  auto p = static_cast<const int*>(part);
  auto f = static_cast<const float*>(xs);
  auto w = static_cast<const float*>(ws);
  auto b = static_cast<const float*>(bias);
  if (out_bf16)
    finish_kernel<__nv_bfloat16><<<blocks, kFinishThreads, 0, s>>>(p, f, w, b, static_cast<__nv_bfloat16*>(out), M, N,
                                                                   1);
  else
    finish_kernel<float><<<blocks, kFinishThreads, 0, s>>>(p, f, w, b, static_cast<float*>(out), M, N, 1);
  return (int)cudaGetLastError();
}

// the product's dynamic shared memory per block in mode 0 row, 1 chunk, 2 split
int intact_w8a8_smem_bytes(int mode) {
  return mode == kRow ? Cfg<kRow>::bytes : mode == kChunk ? Cfg<kChunk>::bytes : Cfg<kSplit>::bytes;
}

const char* intact_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
