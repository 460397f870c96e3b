// Masked grouped-query attention for the Pi0 prefix, hand-written for Hopper (sm_90a).
//
// Replaces intact_tpu/ops/pallas_attention.py::flash_attention (Pallas kernel
// `_attn_kernel`): out = softmax(mask ? (Q K^T) * scale : BIG_NEG) V with fp32
// logits and an fp32 softmax, the probabilities rounded to bf16 before the P.V
// product (fp32 accumulation), KV head = q_head / group, and a fully masked
// query row giving 0 (not the uniform average a plain softmax gives).
//
// Layouts (contiguous): q/out [B, T, H, D], k/v [B, S, KVH, D], mask uint8
// [B, T, S] (nonzero = attend; may be null = attend everywhere). Type: bf16.
// D in {64, 128, 256}.
//
// What bounds it at the Pi0 bridge shape (B=64, T=S=328, H=8, KVH=1, D=256,
// bf16) on an H100 SXM: 4*B*H*T*S*D = 56.4 GFLOP is 57 us at 989 TFLOP/s; the
// bytes it must move (q and out 86 MB each, k+v 21.5 MB, mask 6.9 MB: 200 MB)
// are 60 us at 3.35 TB/s. The two bounds are about equal, and the prefill
// launches it 17 times per inference.
//
// Design: S is short (a few hundred keys), so there is no online-softmax loop.
// One block of 8 warps owns 32 "rows" of one (batch, KV head): the rows are
// the flattened (token, query head of the group) pairs, so the 8 query heads
// that share a KV head are served by one block and each K/V tile is read from
// device memory once per 32 rows, not once per query head. The block
//   1. stages its Q rows, and the mask rows of the tokens they cover, in
//      shared memory,
//   2. walks K in tiles of 64 keys and writes the fp32 logits of all S keys
//      into shared memory (WMMA bf16 tensor-core tiles, fp32 accumulate),
//   3. runs the masked softmax, each warp on its 4 rows side by side, and
//      writes P (bf16) over the logits it came from,
//   4. walks V in tiles of 64 keys accumulating P.V in fp32 WMMA fragments,
//   5. writes the rows back with 16-byte stores.
// Each K/V tile is loaded into registers one tile ahead, so its loads are in
// flight while the block computes on the previous tile.
// Ragged T and S are handled inside: rows past T are computed on zeros and not
// stored, keys past S load as zeros and get probability 0. Shared memory grows
// with S (5 bytes per key per row: the logits and the mask), so S is limited to
// about 1100 keys; the wrapper raises beyond what the device allows. At S=328 a
// block takes 110 KB, so two blocks share an SM. Not yet done: TMA/wgmma, and
// overlapping the phases (loads, Q K^T, softmax, P.V) with one another.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kRows = 32;   // flattened (token, head) rows per block
constexpr int kKeys = 64;   // keys per K/V tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kVec = 8;     // 2-byte elements per 16-byte load
constexpr float kBigNeg = -2.3819763e38f;
using T = __nv_bfloat16;

__host__ __device__ inline size_t round_up(size_t x, size_t m) { return (x + m - 1) / m * m; }

struct Layout {
  int sp;    // S rounded up to a whole K tile
  int ldq;   // row stride (elements) of the Q and K/V tiles
  int ldl;   // row stride (floats) of the logits / P / output staging buffer
  size_t q_off, kv_off, l_off, m_off, bytes;
};

__host__ __device__ inline Layout make_layout(int S, int D) {
  Layout L;
  L.sp = (int)round_up((size_t)S, kKeys);
  L.ldq = D + 8;  // +16 bytes: rows fall on different banks
  L.ldl = (L.sp > D ? L.sp : D) + 4;
  size_t off = 0;
  L.q_off = off;  off += round_up((size_t)kRows * L.ldq * 2, 128);
  L.kv_off = off; off += round_up((size_t)kKeys * L.ldq * 2, 128);
  L.l_off = off;  off += round_up((size_t)kRows * L.ldl * 4, 128);
  L.m_off = off;  off += round_up((size_t)kRows * L.sp, 128);
  L.bytes = off;
  return L;
}


__device__ inline float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ inline float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// A K/V tile moves in two steps so that its loads are in flight while the
// block computes on the previous tile: fetch_tile loads keys [s0, s0 + kKeys)
// of one KV head into registers (zeros past S), stash_tile stores them into
// the shared tile [kKeys][ldq].
template <int D>
__host__ __device__ constexpr int tile_loads() { return kKeys * (D / kVec) / kThreads; }

template <int D>
__device__ inline void fetch_tile(uint4 (&regs)[tile_loads<D>()], const T* __restrict__ src,
                                  int b, int kvh, int s0, int S, int KVH) {
  constexpr int kVecsPerRow = D / kVec;
#pragma unroll
  for (int u = 0; u < tile_loads<D>(); ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int s = s0 + i / kVecsPerRow, c = (i % kVecsPerRow) * kVec;
    regs[u] = s < S ? *reinterpret_cast<const uint4*>(src + (((size_t)b * S + s) * KVH + kvh) * D + c)
                    : make_uint4(0, 0, 0, 0);
  }
}

template <int D>
__device__ inline void stash_tile(T* tile, const uint4 (&regs)[tile_loads<D>()], int ldq) {
  constexpr int kVecsPerRow = D / kVec;
#pragma unroll
  for (int u = 0; u < tile_loads<D>(); ++u) {
    const int i = threadIdx.x + u * kThreads;
    *reinterpret_cast<uint4*>(tile + (i / kVecsPerRow) * ldq + (i % kVecsPerRow) * kVec) = regs[u];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const uint8_t* __restrict__ mask, T* __restrict__ out,
            int T_len, int S, int H, int KVH, float scale) {
  static_assert(D == 64 || D == 128 || D == 256, "head_dim must be 64, 128 or 256");
  constexpr int kVecsPerRow = D / kVec;
  constexpr int kColTiles = D / 64;  // 16-wide output column tiles per warp

  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(S, D);
  T* qs = reinterpret_cast<T*>(smem + L.q_off);
  T* kvs = reinterpret_cast<T*>(smem + L.kv_off);
  float* ls = reinterpret_cast<float*>(smem + L.l_off);
  T* ps = reinterpret_cast<T*>(ls);  // P overwrites the logits, row by row
  const int ldp = 2 * L.ldl;         // P row stride in elements: one logits row
  uint8_t* ms = smem + L.m_off;      // the mask rows of the block's tokens

  const int group = H / KVH;
  const int rows_total = T_len * group;
  const int row0 = blockIdx.x * kRows;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rt = warp & 1;   // this warp's 16-row tile
  const int ct = warp >> 1;  // this warp's 16-column tile (0..3)

  uint4 regs[tile_loads<D>()];
  fetch_tile<D>(regs, k, b, kvh, 0, S, KVH);

  // 1. Q rows: flattened row f -> token f / group, head kvh * group + f % group
  constexpr int kQLoads = kRows * kVecsPerRow / kThreads;
  uint4 qv[kQLoads];
#pragma unroll
  for (int u = 0; u < kQLoads; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int f = row0 + i / kVecsPerRow, c = (i % kVecsPerRow) * kVec;
    qv[u] = make_uint4(0, 0, 0, 0);
    if (f < rows_total) {
      const int t = f / group, h = kvh * group + f % group;
      qv[u] = *reinterpret_cast<const uint4*>(q + (((size_t)b * T_len + t) * H + h) * D + c);
    }
  }
#pragma unroll
  for (int u = 0; u < kQLoads; ++u) {
    const int i = threadIdx.x + u * kThreads;
    *reinterpret_cast<uint4*>(qs + (i / kVecsPerRow) * L.ldq + (i % kVecsPerRow) * kVec) = qv[u];
  }
  //    ... and the mask rows of the tokens they cover (the query heads of a
  //    token share one): 4 bytes a load where the rows allow it
  const int t_first = row0 / group;
  const int n_tok = (min(row0 + kRows, rows_total) - 1) / group - t_first + 1;
  const uint8_t* mtok = mask ? mask + ((size_t)b * T_len + t_first) * S : nullptr;
  if (mtok && S % 4 == 0 && reinterpret_cast<uintptr_t>(mask) % 4 == 0) {
    const int words = S / 4;
    for (int i0 = threadIdx.x; i0 < n_tok * words; i0 += 4 * kThreads) {
      uint32_t mv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kThreads;
        mv[u] = i < n_tok * words ? reinterpret_cast<const uint32_t*>(mtok)[i] : 0u;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kThreads;
        if (i < n_tok * words) *reinterpret_cast<uint32_t*>(ms + (i / words) * L.sp + 4 * (i % words)) = mv[u];
      }
    }
  } else {
    for (int i0 = threadIdx.x; i0 < n_tok * S; i0 += 8 * kThreads) {
      uint8_t mv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * kThreads;
        mv[u] = i < n_tok * S && (!mtok || mtok[i]);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * kThreads;
        if (i < n_tok * S) ms[(i / S) * L.sp + i % S] = mv[u];
      }
    }
  }

  // 2. logits [kRows][sp] = Q K^T, fp32
  for (int s0 = 0; s0 < L.sp; s0 += kKeys) {
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    stash_tile<D>(kvs, regs, L.ldq);
    __syncthreads();
    if (s0 + kKeys < L.sp) fetch_tile<D>(regs, k, b, kvh, s0 + kKeys, S, KVH);
    else fetch_tile<D>(regs, v, b, kvh, 0, S, KVH);  // the first V tile
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> bt;  // K^T
      wmma::load_matrix_sync(a, qs + rt * 16 * L.ldq + d0, L.ldq);
      wmma::load_matrix_sync(bt, kvs + ct * 16 * L.ldq + d0, L.ldq);
      wmma::mma_sync(acc, a, bt, acc);
    }
    wmma::store_matrix_sync(ls + rt * 16 * L.ldl + s0 + ct * 16, acc, L.ldl, wmma::mem_row_major);
  }
  __syncthreads();

  // 3. masked softmax; each warp runs its kRowsPerWarp rows side by side.
  // Fully masked rows -> 0; rows past T are fully masked.
  constexpr int kRowsPerWarp = kRows / kWarps;
  float* lrow[kRowsPerWarp];
  const uint8_t* mrow[kRowsPerWarp];
  bool live[kRowsPerWarp];
  float mx[kRowsPerWarp], sum[kRowsPerWarp];
#pragma unroll
  for (int u = 0; u < kRowsPerWarp; ++u) {
    const int r = warp + u * kWarps, f = row0 + r;
    live[u] = f < rows_total;
    lrow[u] = ls + r * L.ldl;
    mrow[u] = ms + (live[u] ? f / group - t_first : 0) * L.sp;
    mx[u] = kBigNeg;
    sum[u] = 0.0f;
  }
  for (int j = lane; j < S; j += 32) {
#pragma unroll
    for (int u = 0; u < kRowsPerWarp; ++u) {
      const float x = live[u] && mrow[u][j] ? lrow[u][j] * scale : kBigNeg;
      lrow[u][j] = x;
      mx[u] = fmaxf(mx[u], x);
    }
  }
#pragma unroll
  for (int u = 0; u < kRowsPerWarp; ++u) mx[u] = warp_max(mx[u]);
  for (int j = lane; j < S; j += 32) {
#pragma unroll
    for (int u = 0; u < kRowsPerWarp; ++u) {
      const float p = live[u] && mrow[u][j] ? expf(lrow[u][j] - mx[u]) : 0.0f;
      lrow[u][j] = p;
      sum[u] += p;
    }
  }
#pragma unroll
  for (int u = 0; u < kRowsPerWarp; ++u) sum[u] = fmaxf(warp_sum(sum[u]), 1e-30f);
  // P row r overwrites logits row r: element j lands on the bytes of logits
  // element j / 2 <= j, which an earlier iteration (or, for j < 64, another
  // lane of this one) has read
  for (int j = lane; j < L.sp; j += 32) {
    T p[kRowsPerWarp];
#pragma unroll
    for (int u = 0; u < kRowsPerWarp; ++u) p[u] = __float2bfloat16(j < S ? lrow[u][j] / sum[u] : 0.0f);
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kRowsPerWarp; ++u) reinterpret_cast<T*>(lrow[u])[j] = p[u];
    __syncwarp();
  }

  // 4. out [kRows][D] = P V, fp32 accumulate
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[kColTiles];
#pragma unroll
  for (int i = 0; i < kColTiles; ++i) wmma::fill_fragment(o[i], 0.0f);
  for (int s0 = 0; s0 < L.sp; s0 += kKeys) {
    __syncthreads();  // P is complete / the previous V tile is consumed
    stash_tile<D>(kvs, regs, L.ldq);
    __syncthreads();
    if (s0 + kKeys < L.sp) fetch_tile<D>(regs, v, b, kvh, s0 + kKeys, S, KVH);
#pragma unroll
    for (int kk = 0; kk < kKeys; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
      wmma::load_matrix_sync(a, ps + rt * 16 * ldp + s0 + kk, ldp);
#pragma unroll
      for (int i = 0; i < kColTiles; ++i) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bv;
        wmma::load_matrix_sync(bv, kvs + kk * L.ldq + (ct + 4 * i) * 16, L.ldq);
        wmma::mma_sync(o[i], a, bv, o[i]);
      }
    }
  }
  // P is consumed: stage the fp32 output in its buffer
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kColTiles; ++i)
    wmma::store_matrix_sync(ls + rt * 16 * L.ldl + (ct + 4 * i) * 16, o[i], L.ldl, wmma::mem_row_major);
  __syncthreads();

  // 5. write back in the input type
  for (int i = threadIdx.x; i < kRows * kVecsPerRow; i += kThreads) {
    const int r = i / kVecsPerRow, c = (i % kVecsPerRow) * kVec;
    const int f = row0 + r;
    if (f >= rows_total) continue;
    const int t = f / group, h = kvh * group + f % group;
    const float* src = ls + r * L.ldl + c;
    alignas(16) T pack[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) pack[e] = __float2bfloat16(src[e]);
    *reinterpret_cast<uint4*>(out + (((size_t)b * T_len + t) * H + h) * D + c) =
        *reinterpret_cast<const uint4*>(pack);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out,
           int B, int T_len, int S, int H, int KVH, float scale, cudaStream_t stream) {
  const Layout L = make_layout(S, D);
  auto kern = attn_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  const int rows = T_len * (H / KVH);
  dim3 grid((rows + kRows - 1) / kRows, KVH, B);
  kern<<<grid, kThreads, L.bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), T_len, S, H, KVH, scale);
  return (int)cudaGetLastError();
}

int launch_d(const void* q, const void* k, const void* v, const void* mask, void* out,
             int B, int T_len, int S, int H, int KVH, int D, float scale, cudaStream_t stream) {
  switch (D) {
    case 64:  return launch<64>(q, k, v, mask, out, B, T_len, S, H, KVH, scale, stream);
    case 128: return launch<128>(q, k, v, mask, out, B, T_len, S, H, KVH, scale, stream);
    case 256: return launch<256>(q, k, v, mask, out, B, T_len, S, H, KVH, scale, stream);
    default:  return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// bf16 q/k/v/out. Returns a cudaError_t (0 = launched).
int intact_flash_attention(const void* q, const void* k, const void* v, const void* mask, void* out,
                           int B, int T_len, int S, int H, int KVH, int D, float scale, void* stream) {
  return launch_d(q, k, v, mask, out, B, T_len, S, H, KVH, D, scale, static_cast<cudaStream_t>(stream));
}

size_t intact_flash_attention_smem_bytes(int S, int D) { return make_layout(S, D).bytes; }

const char* intact_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
