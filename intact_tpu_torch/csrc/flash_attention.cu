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
// D in {64, 128, 256}; the group G = H / KVH divides 64.
//
// What bounds it at the Pi0 bridge shape (B=64, T=S=328, H=8, KVH=1, D=256,
// bf16) on an H100 SXM: 4*B*H*T*S*D = 56.4 GFLOP is 57 us at 989 TFLOP/s; the
// bytes it must move (q and out 86 MB each, k+v 21.5 MB, mask 6.9 MB: 200 MB)
// are 60 us at 3.35 TB/s. The two bounds are about equal, and the prefill
// launches it 17 times per inference.
//
// Design (warp-specialised, one persistent block of three warpgroups per SM):
//  - Rows are the flattened (token, query head of the group) pairs of one
//    (batch, KV head), so the G query heads that share a KV head share every
//    K/V tile. A work item is 128 rows of one (batch, KV head); each of two
//    consumer warpgroups owns a 64-row Q tile of it. The grid holds one block
//    per SM (fewer when there are fewer items), and each block walks the
//    items in turn, so that the next item's tiles load while the current
//    one finishes.
//  - A producer warpgroup issues the item's Q tiles, then K and V tiles of 64
//    keys by TMA (128-byte swizzle: a D=256 tile is four 64-column boxes)
//    into a two-stage mbarrier ring that runs on across items (Q 64 KB + 2 x
//    (K 32 KB + V 32 KB) at D=256). TMA takes 16-byte strides only, and the
//    mask's row stride is S bytes, so the producer's 128 threads load the
//    mask tile of the item's tokens with ordinary loads (4 bytes where S
//    allows, else bytes) into shared memory beside each K tile, the first
//    words issued before they wait for the slot, writing 0 past T and past S
//    (so keys past S, which TMA fills with zeros, are masked and not given
//    logit 0).
//  - Consumers run S = Q K^T as wgmma m64n64k16 (both operands K-major in
//    shared memory), then an online softmax over the key tiles: running max
//    and sum in fp32, masked probabilities exactly 0 (multiplied by the mask
//    as the reference does, so a tile whose keys are all masked adds nothing
//    even while the running max is still BIG_NEG), O rescaled per tile. P goes
//    to bf16 in registers and is the A operand of O += P V (wgmma m64n64k16
//    per 64 columns of D, V read MN-major from shared memory with the
//    transpose bit). O is normalised once at the end; a fully masked row has
//    sum 0 and O 0 and writes exact 0 (sum clamped to 1e-30).
//  - The two consumer warpgroups take turns at the tensor cores (named
//    barriers), so that one's products overlap the other's softmax.
//  - The epilogue writes O in bf16 into the warpgroup's own Q tile (its last
//    Q K^T is done) in the swizzled layout TMA reads, and one TMA store per
//    box writes it to out (q's layout, so the store clips rows past T); the
//    producer reloads Q for the next item once the store has read the tile.
//    Scattered 4-byte stores from registers cost far more here.
//  - setmaxnreg moves registers from the producer (40) to the consumers (232):
//    O takes 128 fp32 registers a thread at D=256.
// The online softmax rounds the unnormalised P to bf16 where the reference
// rounds the normalised P: the same relative rounding, at another place.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kRowsWG = 64;    // rows per consumer warpgroup (wgmma's M)
constexpr int kConsumers = 2;  // consumer warpgroups per block
constexpr int kRows = kRowsWG * kConsumers;
constexpr int kKeys = 64;      // keys per K/V tile
constexpr int kStages = 2;
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kBox = 64;              // bf16 columns per TMA box: the 128-byte swizzle span
constexpr int kBoxBytes = 64 * 128;   // one box of 64 rows
constexpr int kMaskBatch = 4;  // mask words a producer thread loads before it waits for the slot
constexpr float kBigNeg = -2.3819763e38f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr int kTile = (D / kBox) * kBoxBytes;  // 64 rows x D bf16
  static constexpr int kMask = kRows * kKeys;           // at most kRows tokens (G = 1)
  static constexpr int q = 0;
  static constexpr int k = q + kConsumers * kTile;
  static constexpr int v = k + kStages * kTile;
  static constexpr int mask = v + kStages * kTile;
  static constexpr int bar = mask + kStages * kMask;
  static constexpr int bytes = bar + 8 * (2 + 3 * kStages) + 1024;  // + slack to align the base to 1024
};

#define ACC32(a)                                                                                                      \
  "+f"(a[0]), "+f"(a[1]), "+f"(a[2]), "+f"(a[3]), "+f"(a[4]), "+f"(a[5]), "+f"(a[6]), "+f"(a[7]), "+f"(a[8]),         \
      "+f"(a[9]), "+f"(a[10]), "+f"(a[11]), "+f"(a[12]), "+f"(a[13]), "+f"(a[14]), "+f"(a[15]), "+f"(a[16]),          \
      "+f"(a[17]), "+f"(a[18]), "+f"(a[19]), "+f"(a[20]), "+f"(a[21]), "+f"(a[22]), "+f"(a[23]), "+f"(a[24]),         \
      "+f"(a[25]), "+f"(a[26]), "+f"(a[27]), "+f"(a[28]), "+f"(a[29]), "+f"(a[30]), "+f"(a[31])
#define REGS32                                                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31}"

// d (+)= A B: A [64 x 16] and B [16 x 64] both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32 ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B: A [64 x 16] bf16 in registers, B [16 x 64] MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attn_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
            const uint8_t* __restrict__ mask, int B, int T_len, int S, int H, int KVH, float scale) {
  static_assert(D == 64 || D == 128 || D == 256, "head_dim must be 64, 128 or 256");
  using L = Smem<D>;
  constexpr int kDBoxes = D / kBox;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t bars = smem_u32(smem + L::bar);
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto k_full = [&](int s) { return bars + 8 * (2 + s); };
  auto v_full = [&](int s) { return bars + 8 * (2 + kStages + s); };
  auto empty = [&](int s) { return bars + 8 * (2 + 2 * kStages + s); };

  // work items: (128-row block, KV head, batch), walked by a persistent grid
  const int G = H / KVH;
  const int rows_total = T_len * G;
  const int row_blocks = (rows_total + kRows - 1) / kRows;
  const int n_items = row_blocks * KVH * B;
  const int n_tiles = (S + kKeys - 1) / kKeys;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumers);  // one arrival per consumer warpgroup
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1 + 128);  // the TMA transaction arrival + the producer's mask stores
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), kConsumers * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pt = threadIdx.x - kConsumers * 128;
    const int n_tok = kRows / G;
    // the mask tile [n_tok][kKeys] of the item's tokens, 0 past T and S, in
    // words of 4 keys: 4-byte loads where S and the pointer allow them. The
    // first words are loaded before the wait for the slot, so their latency
    // hides behind the consumers' work.
    const int words = n_tok * (kKeys / 4);
    const bool wide = mask != nullptr && S % 4 == 0 && reinterpret_cast<uintptr_t>(mask) % 4 == 0;
    int tile = 0;  // position in the K/V ring, continued across items
    for (int it = blockIdx.x, n = 0; it < n_items; it += gridDim.x, ++n) {
      const int t0 = (it % row_blocks) * kRows / G, kvh = (it / row_blocks) % KVH, b = it / (row_blocks * KVH);
      auto mask_word = [&](int w, int s0) -> uint32_t {  // word w: 4 keys of one token
        const int t = t0 + w / (kKeys / 4), key = s0 + 4 * (w % (kKeys / 4));
        uint32_t m = 0;
        if (w < words && t < T_len) {
          if (mask == nullptr) {
#pragma unroll
            for (int c = 0; c < 4; ++c) m |= (uint32_t)(key + c < S) << (8 * c);
          } else {
            const uint8_t* row = mask + ((size_t)b * T_len + t) * S;
            if (wide && key + 3 < S) {
              m = __ldg(reinterpret_cast<const uint32_t*>(row + key));
            } else {
#pragma unroll
              for (int c = 0; c < 4; ++c) m |= (uint32_t)(key + c < S && row[key + c] != 0) << (8 * c);
            }
          }
        }
        return m;
      };
      // the item's Q tiles, once the consumers have done the previous item's last Q K^T
      mbar_wait(q_empty, (n & 1) ^ 1);
      if (pt == 0) {
        mbar_expect_tx(q_full, kConsumers * L::kTile);
        for (int c = 0; c < kConsumers; ++c)
          for (int j = 0; j < kDBoxes; ++j)
            tma_load_5d(smem_u32(smem + L::q + c * L::kTile + j * kBoxBytes), &qmap, q_full, j * kBox, 0, kvh,
                        t0 + c * (kRowsWG / G), b);
      }
      for (int i = 0; i < n_tiles; ++i, ++tile) {
        const int s = tile % kStages;
        const int s0 = i * kKeys;
        uint32_t mw[kMaskBatch];  // the first words: all of them where G >= 4
#pragma unroll
        for (int u = 0; u < kMaskBatch; ++u) mw[u] = mask_word(pt + u * 128, s0);
        mbar_wait(empty(s), ((tile / kStages) & 1) ^ 1);
        if (pt == 0) {
          mbar_expect_tx(k_full(s), L::kTile);
          for (int j = 0; j < kDBoxes; ++j)
            tma_load_4d(smem_u32(smem + L::k + s * L::kTile + j * kBoxBytes), &kmap, k_full(s), j * kBox, kvh, s0, b);
          mbar_expect_tx(v_full(s), L::kTile);
          for (int j = 0; j < kDBoxes; ++j)
            tma_load_4d(smem_u32(smem + L::v + s * L::kTile + j * kBoxBytes), &vmap, v_full(s), j * kBox, kvh, s0, b);
        }
        uint32_t* ms = reinterpret_cast<uint32_t*>(smem + L::mask + s * L::kMask);
#pragma unroll
        for (int u = 0; u < kMaskBatch; ++u)
          if (pt + u * 128 < words) ms[pt + u * 128] = mw[u];
        for (int w = pt + kMaskBatch * 128; w < words; w += 128) ms[w] = mask_word(w, s0);  // G < 4
        mbar_arrive(k_full(s));
      }
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int r0 = warp * 16 + lane / 4;  // this thread's rows r0 and r0 + 8 of the warpgroup's 64
    const int c0 = 2 * (lane % 4);        // ... and columns c0, c0 + 1 of every 8
    const int tok[2] = {(wg * kRowsWG + r0) / G, (wg * kRowsWG + r0 + 8) / G};  // rows' tokens in the mask tile
    const uint32_t q_base = smem_u32(smem + L::q + wg * L::kTile);
    const float scale2 = scale * kLog2e;  // logits in log2 units: exp(x - m) = exp2(x2 - m2)

    // The two consumer warpgroups take turns at the tensor cores (named
    // barriers 1 and 2, warpgroup 0 first): one issues its products while the
    // other runs its softmax.
    auto turn_wait = [&]() { asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory"); };
    auto turn_pass = [&]() { asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory"); };
    if (wg == 1) turn_pass();

    int tile = 0;
    for (int it = blockIdx.x, n = 0; it < n_items; it += gridDim.x, ++n) {
      const int f0 = (it % row_blocks) * kRows, kvh = (it / row_blocks) % KVH, b = it / (row_blocks * KVH);
      const int fw = f0 + wg * kRowsWG;  // the warpgroup's first row
      const bool active = fw < rows_total;

      float o[kDBoxes][32];
#pragma unroll
      for (int j = 0; j < kDBoxes; ++j)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[j][e] = 0.0f;
      float m_run[2] = {kBigNeg, kBigNeg}, l_run[2] = {0.0f, 0.0f};

      if (active) mbar_wait(q_full, n & 1);
      for (int i = 0; i < n_tiles; ++i, ++tile) {
        const int s = tile % kStages;
        const uint32_t parity = (tile / kStages) & 1;
        mbar_wait(k_full(s), parity);
        // S = Q K^T over D in steps of 16 (32 bytes within a 128-byte box row)
        float sacc[32];
        turn_wait();
        if (active) {
          const uint32_t k_base = smem_u32(smem + L::k + s * L::kTile);
          wgmma_fence();
#pragma unroll
          for (int kd = 0; kd < D / 16; ++kd) {
            const uint32_t off = (kd / 4) * kBoxBytes + (kd % 4) * 32;
            wgmma_ss(sacc, desc_sw128(q_base + off, 16, 1024), desc_sw128(k_base + off, 16, 1024), kd > 0);
          }
          wgmma_commit();
        }
        turn_pass();
        if (active) {
          wgmma_wait<0>();
#pragma unroll
          for (int e = 0; e < 32; ++e) fence_operand(sacc[e]);
        }
        uint32_t pa[4][4];
        if (active) {
          // masked, scaled logits; accumulator element 4j + 2h + e is row r0 + 8h, key 8j + c0 + e
          const uint8_t* ms = smem + L::mask + s * L::kMask;
          uint32_t keep = 0;
          float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint16_t mm = *reinterpret_cast<const uint16_t*>(ms + tok[h] * kKeys + 8 * j + c0);
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int idx = 4 * j + 2 * h + e;
                const bool on = (mm >> (8 * e)) & 0xff;
                keep |= (uint32_t)on << idx;
                const float x = on ? sacc[idx] * scale2 : kBigNeg;
                sacc[idx] = x;
                mx[h] = fmaxf(mx[h], x);
              }
            }
          float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
            alpha[h] = exp2f(m_run[h] - mx[h]);  // 1 while both are BIG_NEG
            m_run[h] = mx[h];
          }
#pragma unroll
          for (int idx = 0; idx < 32; ++idx) {
            const int h = (idx / 2) % 2;
            const float p = (keep >> idx) & 1u ? exp2f(sacc[idx] - mx[h]) : 0.0f;
            sacc[idx] = p;
            rs[h] += p;
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
            rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
            l_run[h] = l_run[h] * alpha[h] + rs[h];
          }
#pragma unroll
          for (int j = 0; j < kDBoxes; ++j)
#pragma unroll
            for (int e = 0; e < 32; ++e) o[j][e] *= alpha[(e / 2) % 2];

          // P (bf16) as the A operand: k-step kk covers keys 16kk..16kk+15
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int u = 0; u < 4; ++u) pa[kk][u] = pack_bf16(sacc[8 * kk + 2 * u], sacc[8 * kk + 2 * u + 1]);
        }

        // O += P V: V [64 keys x D] MN-major, a 16-key step is 16 rows of 128 bytes
        mbar_wait(v_full(s), parity);
        turn_wait();
        if (active) {
          const uint32_t v_base = smem_u32(smem + L::v + s * L::kTile);
#pragma unroll
          for (int j = 0; j < kDBoxes; ++j)
#pragma unroll
            for (int e = 0; e < 32; ++e) fence_operand(o[j][e]);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int j = 0; j < kDBoxes; ++j)
              wgmma_rs(o[j], pa[kk], desc_sw128(v_base + j * kBoxBytes + kk * 16 * 128, kBoxBytes, 1024));
          wgmma_commit();
        }
        turn_pass();
        if (active) {
          wgmma_wait<0>();
#pragma unroll
          for (int j = 0; j < kDBoxes; ++j)
#pragma unroll
            for (int e = 0; e < 32; ++e) fence_operand(o[j][e]);
        }
        mbar_arrive(empty(s));
      }

      // epilogue: O / sum in bf16 into the warpgroup's Q tile (free now: its
      // last Q K^T is done), laid out as TMA wrote Q (128-byte swizzled
      // rows), then one TMA store to out, which has q's layout; rows past T
      // are clipped by the store. The next item's Q may come once the store
      // has read the tile.
      if (active) {
        uint8_t* qs = smem + L::q + wg * L::kTile;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          const float inv = 1.0f / fmaxf(l_run[h], 1e-30f);  // fully masked: O = 0 -> 0
#pragma unroll
          for (int j = 0; j < kDBoxes; ++j)
#pragma unroll
            for (int c = 0; c < 8; ++c)
              *reinterpret_cast<__nv_bfloat162*>(qs + j * kBoxBytes + r * 128 + ((c ^ (r & 7)) * 16) + c0 * 2) =
                  __floats2bfloat162_rn(o[j][4 * c + 2 * h] * inv, o[j][4 * c + 2 * h + 1] * inv);
        }
        fence_async_shared();
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");  // this warpgroup's writes are done
      if (tid == 0) {
        if (active) {
          const int t0 = f0 / G;
          for (int j = 0; j < kDBoxes; ++j)
            tma_store_5d(&omap, q_base + j * kBoxBytes, j * kBox, 0, kvh, t0 + wg * (kRowsWG / G), b);
          bulk_commit();
          bulk_wait_read();
        }
        mbar_arrive(q_empty);
      }
    }
    if (wg == 0) turn_wait();  // warpgroup 1's last pass
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out, int B, int T_len, int S, int H,
           int KVH, float scale, cudaStream_t stream) {
  using L = Smem<D>;
  const int G = H / KVH;
  if (H % KVH || kRowsWG % G) return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, kmap, vmap, omap;
  const cuuint64_t e = 2;  // bytes per element
  // q as [B][T][KVH][G][D]: a box is G heads x 64/G tokens = 64 rows of 64 columns
  const cuuint64_t q_dims[5] = {(cuuint64_t)D, (cuuint64_t)G, (cuuint64_t)KVH, (cuuint64_t)T_len, (cuuint64_t)B};
  const cuuint64_t q_strides[4] = {D * e, (cuuint64_t)G * D * e, (cuuint64_t)H * D * e, (cuuint64_t)T_len * H * D * e};
  const cuuint32_t q_box[5] = {kBox, (cuuint32_t)G, 1, (cuuint32_t)(kRowsWG / G), 1};
  // k, v as [B][S][KVH][D]: a box is 64 keys of 64 columns of one KV head
  const cuuint64_t kv_dims[4] = {(cuuint64_t)D, (cuuint64_t)KVH, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t kv_strides[3] = {D * e, (cuuint64_t)KVH * D * e, (cuuint64_t)S * KVH * D * e};
  const cuuint32_t kv_box[4] = {kBox, 1, kKeys, 1};
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  const auto ty = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!make_map(&qmap, ty, 5, q, q_dims, q_strides, q_box, sw) ||
      !make_map(&omap, ty, 5, out, q_dims, q_strides, q_box, sw) ||
      !make_map(&kmap, ty, 4, k, kv_dims, kv_strides, kv_box, sw) ||
      !make_map(&vmap, ty, 4, v, kv_dims, kv_strides, kv_box, sw))
    return (int)cudaErrorInvalidValue;
  auto kern = attn_kernel<D>;
  static bool attribute_set = false;  // once per head_dim (and device: the port runs on one)
  if (!attribute_set) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
    if (err != cudaSuccess) return (int)err;  // e.g. a card with less shared memory than Hopper's 227 KB
    attribute_set = true;
  }
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_items = (T_len * G + kRows - 1) / kRows * KVH * B;
  kern<<<n_items < n_sm ? n_items : n_sm, kThreads, L::bytes, stream>>>(
      qmap, kmap, vmap, omap, static_cast<const uint8_t*>(mask), B, T_len, S, H, KVH, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 q/k/v/out. Returns a cudaError_t (0 = launched).
int intact_flash_attention(const void* q, const void* k, const void* v, const void* mask, void* out, int B, int T_len,
                           int S, int H, int KVH, int D, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(q, k, v, mask, out, B, T_len, S, H, KVH, scale, st);
    case 128: return launch<128>(q, k, v, mask, out, B, T_len, S, H, KVH, scale, st);
    case 256: return launch<256>(q, k, v, mask, out, B, T_len, S, H, KVH, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the kernel's dynamic shared memory per block, for head_dim D (0 if unsupported)
int intact_flash_attention_smem_bytes(int D) {
  return D == 64 ? Smem<64>::bytes : D == 128 ? Smem<128>::bytes : D == 256 ? Smem<256>::bytes : 0;
}

const char* intact_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
