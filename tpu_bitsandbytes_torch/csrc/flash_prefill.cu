// K3: causal GQA flash attention for aligned prefill, for Hopper (sm_90a).
//
// Replaces tpu_bitsandbytes/ops/flash_prefill.py:_kernel (pallas_call at
// :135) and computes what it does, over 128-query tiles and key tiles of BK
// keys (128 at D = 64 and 128, 64 at D = 256) in place of 512 x 512: for
// each query tile, key tiles from the window's first tile up to the causal
// diagonal;
//     lg = dot(q, k) * scale in f32 (bf16 or f16 operands), optional
//     softcap tanh(lg / cap) * cap; masked logits (keep kpos <= qpos,
//     kpos < s_real and the window) are -1e30;
//     m_new = max(m, rowmax(lg)), p = exp(lg - m_new), alpha = exp(m - m_new),
//     l = l * alpha + rowsum(p), acc = acc * alpha + dot(half(p), v),
// with m starting at -1e30, and out = acc / max(l, 1e-38) in the operands'
// type. A row whose tile is all masked gets p = 1 there, as in the TPU
// kernel; its first kept key scales that away (alpha = 0).
//
// Bound on the H100: the operations, 4 * B * H * D * (kept (q, k) pairs)
// over the dense bf16 peak; the bytes (q, k, v and out once each) are a few
// per cent of that time at S >= 1024. Besides the tensor cores, each logit
// costs an expf and a few f32 operations, which the design keeps off the
// tensor cores' path where it can.
//
// Design (after FlashAttention-3): one block of three warpgroups per (128
// queries, head, batch row), the longest query tiles launched first.
// Warpgroup 0 is the producer: one thread loads the Q tile once and keeps
// the K and V tiles (BK keys x D) in flight through a 2-stage ring in
// dynamic shared memory (Q and the ring: 164,936 bytes at D = 128, 83,016
// at D = 64, 197,704 at D = 256, barriers and alignment included; 128-key
// tiles at D = 256 would need 256 KB, past the 227 KB a block may take), by TMA (cp.async.bulk.tensor from a 4-D tensor map
// over [B, S, H, D], 128-byte swizzle, rows past S zero-filled), with full
// and empty mbarriers for K and for V apart, so a K tile is refilled as soon
// as its S product is done. Warpgroups 1 and 2 each own 64 query rows:
// S = Q K^T is one wgmma.mma_async m64nBKk16 chain per tile (Q and K read
// from the swizzled tiles through descriptors, f32 accumulate); the online
// softmax runs on the accumulator registers; p, rounded to the operands'
// type, goes from the S accumulator straight into the register A operand of
// the PV chain, and V is the shared-memory B operand in its token-major
// layout (the descriptor's transpose bit, no explicit transpose). Each
// warpgroup issues PV of tile j - 1 with S of tile j as one wgmma group, and
// the two take turns to issue (named barriers), so one's softmax runs while
// the other's products keep the tensor cores busy. The producer gives up
// registers to the consumers (setmaxnreg). Tiles that no mask touches skip
// the mask. GQA reads kv head h / rep. A consumer thread holds D / 2 f32
// of O, BK / 2 of S and BK / 4 words of p: 160 registers at D = 128 and
// 176 at D = 256, where the 64-key tile halves S and p.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BQ = 128, STAGES = 2;
constexpr int THREADS = 384;        // producer warpgroup + 2 consumer warpgroups
constexpr float NEG = -1e30f;

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle
// repeats every 1024 bytes): Q, the K ring, the V ring, the barriers. A
// tile is D / 64 sub-tiles of [rows][64 columns], 128 bytes a row.
template <int D>
struct Layout {
  static constexpr int BK = D == 256 ? 64 : 128;  // keys per K/V tile
  static constexpr int NSUB = D / 64;             // 64-column sub-tiles per row
  static constexpr int SUBQ = BQ * 128;           // a [128 rows][64 columns] sub-tile
  static constexpr int SUBK = BK * 128;           // a [BK rows][64 columns] sub-tile
  static constexpr int QTILE = NSUB * SUBQ;       // the 128 x D Q tile
  static constexpr int KTILE = NSUB * SUBK;       // one BK x D K or V tile
  static constexpr int Q = 0;
  static constexpr int K = QTILE;
  static constexpr int V = K + STAGES * KTILE;
  static constexpr int BAR = V + STAGES * KTILE;
  static constexpr int BYTES = BAR + 8 * (1 + 4 * STAGES) + 1024;  // + alignment
};
static_assert(Layout<128>::BYTES == 164936 && Layout<64>::BYTES == 83016 &&
                  Layout<256>::BYTES == 197704,
              "the header states these sizes");

// the barriers after Q's: full and empty, for K and for V, one per stage
__device__ __forceinline__ uint32_t full_k(uint32_t bar, int s) { return bar + 8 * (1 + s); }
__device__ __forceinline__ uint32_t full_v(uint32_t bar, int s) {
  return bar + 8 * (1 + STAGES + s);
}
__device__ __forceinline__ uint32_t empty_k(uint32_t bar, int s) {
  return bar + 8 * (1 + 2 * STAGES + s);
}
__device__ __forceinline__ uint32_t empty_v(uint32_t bar, int s) {
  return bar + 8 * (1 + 3 * STAGES + s);
}

// the consumer warpgroups' turns to issue: warpgroup w waits on barrier
// 1 + w, which the other warpgroup arrives at
__device__ __forceinline__ void sched_sync(int wg) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(1 + wg) : "memory");
}
__device__ __forceinline__ void sched_arrive(int wg) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(1 + wg) : "memory");
}

// d[BK/2] (+)= A (64 x 16, smem) * B (16 x BK, smem), both K-major
template <int BK, bool F16>
__device__ __forceinline__ void wgmma_qk(float* d, uint64_t da, uint64_t db, int scale_d) {
  if constexpr (BK == 128) {
#define TBNB_QK128(TY)                                                                    \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                               \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32" TY " " TBNB_D64              \
               ", %64, %65, p, 1, 1, 0, 0;\n}\n"                                          \
               : TBNB_ACC64(d)                                                            \
               : "l"(da), "l"(db), "r"(scale_d))
    if constexpr (F16) TBNB_QK128(".f16.f16"); else TBNB_QK128(".bf16.bf16");
#undef TBNB_QK128
  } else {
#define TBNB_QK64(TY)                                                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                               \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32" TY " " TBNB_D32               \
               ", %32, %33, p, 1, 1, 0, 0;\n}\n"                                          \
               : TBNB_ACC32(d)                                                            \
               : "l"(da), "l"(db), "r"(scale_d))
    if constexpr (F16) TBNB_QK64(".f16.f16"); else TBNB_QK64(".bf16.bf16");
#undef TBNB_QK64
  }
}

// d[D/2] += A (64 x 16, registers) * B (16 x D, smem, N-major: transposed)
template <int D, bool F16>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (D == 256) {
#define TBNB_PV256(TY)                                                                    \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                              \
               "wgmma.mma_async.sync.aligned.m64n256k16.f32" TY " " TBNB_D128             \
               ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"                       \
               : TBNB_ACC128(d)                                                           \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
    if constexpr (F16) TBNB_PV256(".f16.f16"); else TBNB_PV256(".bf16.bf16");
#undef TBNB_PV256
  } else if constexpr (D == 128) {
#define TBNB_PV128(TY)                                                                    \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                               \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32" TY " " TBNB_D64              \
               ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                           \
               : TBNB_ACC64(d)                                                            \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
    if constexpr (F16) TBNB_PV128(".f16.f16"); else TBNB_PV128(".bf16.bf16");
#undef TBNB_PV128
  } else {
#define TBNB_PV64(TY)                                                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                               \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32" TY " " TBNB_D32               \
               ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                           \
               : TBNB_ACC32(d)                                                            \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
    if constexpr (F16) TBNB_PV64(".f16.f16"); else TBNB_PV64(".bf16.bf16");
#undef TBNB_PV64
  }
}

template <bool F16>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (F16) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int D, bool F16>
__global__ void __launch_bounds__(THREADS, 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, uint16_t* __restrict__ out,
                     int S, int H, int Hkv, int s_real, int window, int has_window,
                     float scale, float softcap) {
  using L = Layout<D>;
  constexpr int BK = L::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const uint32_t bar = base + L::BAR;  // Q's, then full_k, full_v, empty_k, empty_v
  const int tid = threadIdx.x;
  const int qi = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  int kt_lo = 0;
  if (has_window) {
    const int lo = qi * BQ - window + 1;  // smallest key any row keeps
    kt_lo = lo > 0 ? lo / BK : 0;
  }
  const int n_tiles = (qi * BQ + BQ - 1) / BK - kt_lo + 1;  // up to the diagonal

  if (tid == 0) {
    mbar_init(bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(bar, s), 1);
      mbar_init(full_v(bar, s), 1);
      mbar_init(empty_k(bar, s), 8);  // lane 0 of each consumer warp
      mbar_init(empty_v(bar, s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      mbar_expect_tx(bar, L::QTILE);
      for (int j = 0; j < L::NSUB; ++j)
        for (int r = 0; r < BQ; r += BK)  // the tensor maps' boxes are BK rows
          tma_load(base + L::Q + j * L::SUBQ + r * 128, &tq, bar, 64 * j, h, qi * BQ + r, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        const uint32_t free_ph = ((i / STAGES) & 1) ^ 1;
        const int row = (kt_lo + i) * BK;
        mbar_wait(empty_k(bar, s), free_ph);
        mbar_expect_tx(full_k(bar, s), L::KTILE);
        for (int j = 0; j < L::NSUB; ++j)
          tma_load(base + L::K + s * L::KTILE + j * L::SUBK, &tk, full_k(bar, s), 64 * j, hk,
                   row, b);
        mbar_wait(empty_v(bar, s), free_ph);
        mbar_expect_tx(full_v(bar, s), L::KTILE);
        for (int j = 0; j < L::NSUB; ++j)
          tma_load(base + L::V + s * L::KTILE + j * L::SUBK, &tv, full_v(bar, s), 64 * j, hk,
                   row, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ct = tid - 128;
    const int cw = ct >> 7, warp = (ct >> 5) & 3, lane = ct & 31;
    const int g = lane >> 2, t = lane & 3;
    const int q0 = qi * BQ, q_last = q0 + BQ - 1;
    const int qpos[2] = {q0 + cw * 64 + warp * 16 + g, q0 + cw * 64 + warp * 16 + g + 8};
    const uint32_t q_tile = base + L::Q + cw * 64 * 128;  // this warpgroup's rows

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    float m_r[2] = {NEG, NEG}, l_r[2] = {0.f, 0.f};
    uint32_t pa[BK / 16][4];  // p of the last tile as the A operand of PV, k16 step kk

    // online softmax of the tile at key k0 on its S accumulator (sc[4i + e]
    // is row qpos[e >> 1], key k0 + 8i + 2t + (e & 1)); leaves p in pa and
    // O rescaled by alpha
    auto softmax = [&](int k0) {
      const bool masked = k0 + BK - 1 > q0 || k0 + BK > s_real ||
                          (has_window && k0 <= q_last - window);
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * i + e] * scale;
          if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
          if (masked) {
            const int kpos = k0 + 8 * i + 2 * t + (e & 1);
            const int qp = qpos[e >> 1];
            bool keep = kpos <= qp && kpos < s_real;
            if (has_window) keep = keep && kpos > qp - window;
            x = keep ? x : NEG;
          }
          sc[4 * i + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_r[r], quad_max(mx[r]));
        alpha[r] = expf(m_r[r] - m_new);
        m_r[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = expf(sc[4 * i + e] - m_r[e >> 1]);
          ls[e >> 1] += p[e];
        }
        pa[i >> 1][(i & 1) * 2] = pack2<F16>(p[0], p[1]);
        pa[i >> 1][(i & 1) * 2 + 1] = pack2<F16>(p[2], p[3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + quad_sum(ls[r]);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[4 * i] *= alpha[0];
        o[4 * i + 1] *= alpha[0];
        o[4 * i + 2] *= alpha[1];
        o[4 * i + 3] *= alpha[1];
      }
    };
    auto issue_qk = [&](int s) {  // S = Q K^T
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk & 3) * 32;  // this k16 step's bytes in a 128-byte row
        wgmma_qk<BK, F16>(sc, sw128(q_tile + (kk >> 2) * L::SUBQ + col, 16, 1024),
                          sw128(base + L::K + s * L::KTILE + (kk >> 2) * L::SUBK + col, 16,
                                1024),
                          kk > 0);
      }
    };
    auto issue_pv = [&](int s) {  // O += P V, V token-major in the ring
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_pv<D, F16>(o, pa[kk],
                         sw128(base + L::V + s * L::KTILE + kk * 2048, L::SUBK, 1024));
    };

    // Phase j issues PV of tile j - 1 and S of tile j as one wgmma group,
    // then runs the softmax of tile j. The two warpgroups take turns to
    // issue (named barriers 1 and 2), so one's softmax overlaps the other's
    // products. Every wgmma is issued outside a branch: ptxas serializes
    // wgmma chains in divergent paths.
    mbar_wait(bar, 0);
    if (cw == 1) sched_arrive(0);  // warpgroup 0 issues first
    sched_sync(cw);
    mbar_wait(full_k(bar, 0), 0);
    fence_regs<BK / 2>(sc);
    wg_fence();
    issue_qk(0);
    wg_commit();
    sched_arrive(1 - cw);
    wg_wait();
    fence_regs<BK / 2>(sc);
    if (lane == 0) mbar_arrive(empty_k(bar, 0));
    softmax(kt_lo * BK);
    for (int j = 1; j < n_tiles; ++j) {
      const int sq = j % STAGES, sv = (j - 1) % STAGES;
      sched_sync(cw);
      mbar_wait(full_k(bar, sq), (j / STAGES) & 1);
      mbar_wait(full_v(bar, sv), ((j - 1) / STAGES) & 1);
      fence_regs<BK / 2>(sc);
      fence_regs<D / 2>(o);
      wg_fence();
      issue_pv(sv);
      issue_qk(sq);
      wg_commit();
      sched_arrive(1 - cw);
      wg_wait();
      fence_regs<BK / 2>(sc);
      fence_regs<D / 2>(o);
      if (lane == 0) {
        mbar_arrive(empty_k(bar, sq));
        mbar_arrive(empty_v(bar, sv));
      }
      softmax((kt_lo + j) * BK);
    }
    const int sv = (n_tiles - 1) % STAGES;
    sched_sync(cw);
    mbar_wait(full_v(bar, sv), ((n_tiles - 1) / STAGES) & 1);
    fence_regs<D / 2>(o);
    wg_fence();
    issue_pv(sv);
    wg_commit();
    if (cw == 0) sched_arrive(1);  // no turn follows warpgroup 1's last
    wg_wait();
    fence_regs<D / 2>(o);

    const size_t q_stride = (size_t)H * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qpos[r] >= S) continue;
      const float den = fmaxf(l_r[r], 1e-38f);
      uint16_t* orow = out + ((size_t)b * S + qpos[r]) * q_stride + (size_t)h * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
            pack2<F16>(o[4 * j + 2 * r] / den, o[4 * j + 2 * r + 1] / den);
    }
  }
}

// [B, S, heads, D] contiguous, read as box_rows rows x 64 columns of one head
bool head_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int D, int box_rows,
              bool f16) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return enc(map, f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(ptr), dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool F16>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
           int Hkv, int s_real, int window, int has_window, float scale, float softcap,
           cudaStream_t st) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_kernel<D, F16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Layout<D>::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  CUtensorMap tq, tk, tv;
  constexpr int BK = Layout<D>::BK;
  if (!head_map(&tq, q, B, S, H, D, BK, F16) || !head_map(&tk, k, B, S, Hkv, D, BK, F16) ||
      !head_map(&tv, v, B, S, Hkv, D, BK, F16))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_prefill_kernel<D, F16><<<grid, THREADS, Layout<D>::BYTES, st>>>(
      tq, tk, tv, static_cast<uint16_t*>(out), S, H, Hkv, s_real, window, has_window, scale,
      softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, S, H, D], k/v [B, S, Hkv, D], out [B, S, H, D], all contiguous, in
// bf16 (is_f16 = 0) or f16; D in {64, 128, 256}; H % Hkv == 0. softcap <= 0
// disables the cap; has_window = 0 the window. Returns cudaGetLastError()
// (cudaErrorInvalidValue where a tensor map cannot be made).
extern "C" int tbnb_flash_prefill(const void* q, const void* k, const void* v, void* out,
                                  int B, int S, int H, int Hkv, int D, int s_real,
                                  int window, int has_window, int is_f16, float scale,
                                  float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TBNB_FP_ARGS q, k, v, out, B, S, H, Hkv, s_real, window, has_window, scale, softcap, st
  if (D == 64) return is_f16 ? launch<64, true>(TBNB_FP_ARGS) : launch<64, false>(TBNB_FP_ARGS);
  if (D == 128) return is_f16 ? launch<128, true>(TBNB_FP_ARGS) : launch<128, false>(TBNB_FP_ARGS);
  if (D == 256) return is_f16 ? launch<256, true>(TBNB_FP_ARGS) : launch<256, false>(TBNB_FP_ARGS);
#undef TBNB_FP_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
