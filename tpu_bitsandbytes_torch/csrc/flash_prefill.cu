// K3: causal GQA flash attention for aligned prefill, for Hopper (sm_90a).
//
// Replaces tpu_bitsandbytes/ops/flash_prefill.py:_kernel (pallas_call at
// :135) and computes what it does, over 64 x 64 tiles in place of 512 x 512:
// for each query tile, key tiles from the window's first tile up to the
// causal diagonal;
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
// per cent of that time at S >= 1024.
//
// Design: one block of 4 warps per (64 queries, head, batch row), the
// longest query tiles launched first. Each warp owns 16 query rows: their
// Q fragments stay in registers, and the S = QK^T tile, the online softmax
// and the O accumulator live in mma.sync m16n8k16 fragments (f32 accumulate);
// p goes from the S fragments straight into the A fragments of the PV
// product, and V's B fragments come from shared memory through
// ldmatrix.trans. Each key tile is staged in shared memory (K and V, 64 rows
// padded against bank conflicts) by all threads. GQA reads kv head h / rep.
// No TMA, no double buffering and no wgmma yet: those are for the PRs that
// make this kernel fast.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64, BKV = 64, THREADS = 128;
constexpr float NEG = -1e30f;

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

template <bool F16>
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  if constexpr (F16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// rows [row0, row0 + 64) of a token-major [S, stride] operand (one head's
// D columns at src) into a padded [64][LD] tile; rows past S are zero
template <int D, int LD>
__device__ __forceinline__ void load_tile(uint16_t* dst, const uint16_t* src,
                                          size_t stride, int row0, int S) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < BKV * CH; c += THREADS) {
    const int r = c / CH, part = (c % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * stride + part);
    *reinterpret_cast<uint4*>(dst + r * LD + part) = val;
  }
}

template <int D, bool F16>
__global__ void __launch_bounds__(THREADS)
flash_prefill_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                     const uint16_t* __restrict__ v, uint16_t* __restrict__ out, int S,
                     int H, int Hkv, int s_real, int window, int has_window,
                     float scale, float softcap) {
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;  // k16 steps of QK^T
  constexpr int ND = D / 8;   // n8 tiles of O
  __shared__ __align__(16) uint16_t Ks[BKV * LD];
  __shared__ __align__(16) uint16_t Vs[BKV * LD];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qi = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)Hkv * D;
  const uint16_t* qb = q + (size_t)b * S * q_stride + (size_t)h * D;
  const uint16_t* kb = k + (size_t)b * S * kv_stride + (size_t)hk * D;
  const uint16_t* vb = v + (size_t)b * S * kv_stride + (size_t)hk * D;
  const int wr = warp * 16;

  // this warp's 16 query rows as A fragments, through the K buffer
  load_tile<D, LD>(Ks, qb, q_stride, qi * BQ, S);
  __syncthreads();
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint16_t* r0 = Ks + (wr + g) * LD + ks * 16 + 2 * t;
    qa[ks][0] = *reinterpret_cast<const uint32_t*>(r0);
    qa[ks][1] = *reinterpret_cast<const uint32_t*>(r0 + 8 * LD);
    qa[ks][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
    qa[ks][3] = *reinterpret_cast<const uint32_t*>(r0 + 8 * LD + 8);
  }
  __syncthreads();

  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  float m_r[2] = {NEG, NEG}, l_r[2] = {0.f, 0.f};
  const int qpos[2] = {qi * BQ + wr + g, qi * BQ + wr + g + 8};
  int kt_lo = 0;
  if (has_window) {
    const int lo = qi * BQ - window + 1;  // smallest key any row keeps
    kt_lo = lo > 0 ? lo / BKV : 0;
  }

  for (int kt = kt_lo; kt <= qi; ++kt) {
    load_tile<D, LD>(Ks, kb, kv_stride, kt * BKV, S);
    load_tile<D, LD>(Vs, vb, kv_stride, kt * BKV, S);
    __syncthreads();

    float sc[8][4];
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[ni][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const uint16_t* kr = Ks + (ni * 8 + g) * LD + ks * 16 + 2 * t;
        mma16816<F16>(sc[ni], qa[ks], *reinterpret_cast<const uint32_t*>(kr),
                      *reinterpret_cast<const uint32_t*>(kr + 8));
      }

    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = kt * BKV + ni * 8 + 2 * t + (e & 1);
        const int qp = qpos[e >> 1];
        float x = sc[ni][e] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        bool keep = kpos <= qp && kpos < s_real;
        if (has_window) keep = keep && kpos > qp - window;
        x = keep ? x : NEG;
        sc[ni][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m_r[i], quad_max(mx[i]));
      alpha[i] = expf(m_r[i] - m_new);
      m_r[i] = m_new;
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[ni][e] - m_r[e >> 1]);
        sc[ni][e] = p;
        ls[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * alpha[i] + quad_sum(ls[i]);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      o[nd][0] *= alpha[0]; o[nd][1] *= alpha[0];
      o[nd][2] *= alpha[1]; o[nd][3] *= alpha[1];
    }

    // PV: the S fragments of keys 16j..16j+15 are the A fragment of step j
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t pa[4] = {pack2<F16>(sc[2 * j][0], sc[2 * j][1]),
                              pack2<F16>(sc[2 * j][2], sc[2 * j][3]),
                              pack2<F16>(sc[2 * j + 1][0], sc[2 * j + 1][1]),
                              pack2<F16>(sc[2 * j + 1][2], sc[2 * j + 1][3])};
      const uint16_t* vrow = Vs + (16 * j + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vrow + nd * 8);
        mma16816<F16>(o[nd], pa, bf[0], bf[1]);
        mma16816<F16>(o[nd + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();
  }

  const float den[2] = {fmaxf(l_r[0], 1e-38f), fmaxf(l_r[1], 1e-38f)};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qpos[i] >= S) continue;
    uint16_t* orow = out + ((size_t)b * S + qpos[i]) * q_stride + (size_t)h * D;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<uint32_t*>(orow + nd * 8 + 2 * t) =
          pack2<F16>(o[nd][2 * i] / den[i], o[nd][2 * i + 1] / den[i]);
  }
}

template <int D, bool F16>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S,
           int H, int Hkv, int s_real, int window, int has_window, float scale,
           float softcap, cudaStream_t st) {
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_prefill_kernel<D, F16><<<grid, THREADS, 0, st>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(out), S, H, Hkv, s_real,
      window, has_window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, S, H, D], k/v [B, S, Hkv, D], out [B, S, H, D], all contiguous, in
// bf16 (is_f16 = 0) or f16; D in {64, 128}; H % Hkv == 0. softcap <= 0
// disables the cap; has_window = 0 the window. Returns cudaGetLastError().
extern "C" int tbnb_flash_prefill(const void* q, const void* k, const void* v, void* out,
                                  int B, int S, int H, int Hkv, int D, int s_real,
                                  int window, int has_window, int is_f16, float scale,
                                  float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TBNB_FP_ARGS q, k, v, out, B, S, H, Hkv, s_real, window, has_window, scale, softcap, st
  if (D == 64) return is_f16 ? launch<64, true>(TBNB_FP_ARGS) : launch<64, false>(TBNB_FP_ARGS);
  if (D == 128) return is_f16 ? launch<128, true>(TBNB_FP_ARGS) : launch<128, false>(TBNB_FP_ARGS);
#undef TBNB_FP_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
