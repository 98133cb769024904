// K4: packed NF4 x A8 matmul at decode and small-prefill M, for Hopper (sm_90a).
//
// Replaces tpu_bitsandbytes/ops/w4a8.py:_w4a8_kernel (pallas_call at :141).
// Computes
//     out[m, n] = sx[m] * sum_b (absmax[n, b] * (1/127))
//                         * dot_i32(x[m, blk b], NF4_I8[code[n, blk b]])
// with x int8 [M, Kp] (the A8 row codes), w packed NF4 codes [N, Kp/2]
// (element 2j in the low nibble), absmax f32 [N, Kp/bs], sx f32 [M] and
// NF4_I8 the 16-entry int8 codebook round(NF4 * 127). Each block's dot is
// one exact int32 sum (the TPU kernel dots the even and the odd K planes
// apart; their sum is the same integer), scaled by one f32 multiply-add with
// absmax * f32(1/127); the row scale multiplies last. Only the f32 order of
// the block sums can differ from the TPU kernel's.
//
// Bound on the H100: the packed bytes. At M <= 64 the kernel reads N*Kp/2
// bytes of codes and 4*N*Kp/bs of absmax against 2*M*N*Kp int8 operations,
// at most 256 operations per byte: below the ~590 int8 operations per byte
// of HBM bandwidth even at the tensor cores' rate. In practice the integer
// pipe that decodes the codes (about 1.4 instructions per code) comes next.
//
// Design (blocksizes that are powers of two from 32 up): the int8
// tensor-core ring of a8_tc.cuh (mma.sync m16n8k32 over one decoded
// fragment, a 3-stage cp.async ring of 256-code chunks, a wave-aware split
// along K chosen once per shape by tbnb_w4a8_plan, a deterministic split
// reduction), with the codes decoded to int8 by three byte permutes per four
// codes and absmax [N, Kp/bs] loaded per row.
//
// Other blocksizes (4-16, and multiples of 4 that are not powers of two)
// take the second path: one warp per two weight rows, __dp4a over 32 codes
// per lane, and each 4-code group's partial scaled by its block's absmax.

#include <cuda_runtime.h>
#include <stdint.h>

#include "a8_tc.cuh"

namespace {

constexpr float INV127 = 1.0f / 127.0f;

struct Table {
  uint32_t t0, t1, t2, t3;  // entries 0-3, 4-7, 8-11, 12-15, one per byte
};

// The eight codes of v (element order: bits 0-3 first) -> their int8 table
// values, codes 0-3 in lo and 4-7 in hi, byte i for code i. For four codes:
// two lookups give entries 0-7 and 8-15 of the low three bits, and a third
// picks byte i from the second where bit 3 of code i is set (selector i or
// 4 + i). The byte permutes read only the low 16 bits of their selector.
__device__ __forceinline__ void nf4_decode8(uint32_t v, const Table& tb, uint32_t& lo,
                                            uint32_t& hi) {
  const uint32_t sel = v & 0x77777777u;
  const uint32_t pick = 0x32103210u | ((v >> 1) & 0x44444444u);
  lo = __byte_perm(__byte_perm(tb.t0, tb.t1, sel), __byte_perm(tb.t2, tb.t3, sel), pick);
  const uint32_t sel_hi = sel >> 16, pick_hi = pick >> 16;
  hi = __byte_perm(__byte_perm(tb.t0, tb.t1, sel_hi), __byte_perm(tb.t2, tb.t3, sel_hi),
                   pick_hi);
}

// ---------------------------------------------------------------------------
// tensor-core path: a8_tc.cuh with the NF4 decode and absmax [N, Kp/bs]
// ---------------------------------------------------------------------------

constexpr int AM_PITCH = a8tc::KC / 32;  // absmax entries per row and chunk
static_assert(a8tc::TC_ROWS * AM_PITCH * 4 == a8tc::SC_STAGE, "absmax fills the scale stage");

struct Nf4 {
  using Arg = Table;

  static __device__ __forceinline__ void decode8(uint32_t v, const Table& tb, uint32_t& lo,
                                                 uint32_t& hi) {
    nf4_decode8(v, tb, lo, hi);
  }

  // absmax[n0 .. n0+63][blocks of chunk c] -> am[row * AM_PITCH + j]
  static __device__ __forceinline__ void load_scales(float* am, const float* absmax, int c,
                                                     int n0, int N, int Kp, int lbs) {
    using a8tc::LKC;
    const int tid = threadIdx.x;
    const int lper = lbs < LKC ? LKC - lbs : 0;  // log2 of the blocks this chunk touches
    const int nb = Kp >> lbs, b0 = (c * a8tc::KC) >> lbs;
    // 4 entries per copy where they are 16-byte aligned
    if (lper >= 2 && (nb & 3) == 0 && (reinterpret_cast<uintptr_t>(absmax) & 15) == 0) {
      for (int i = tid; i < (a8tc::TC_ROWS << (lper - 2)); i += a8tc::TC_WARPS * 32) {
        const int r = i >> (lper - 2), j = (i & ((1 << (lper - 2)) - 1)) << 2;
        const int n = n0 + r, b = b0 + j;
        const bool ok = n < N && b < nb;
        a8tc::cp_async16(am + r * AM_PITCH + j,
                         ok ? static_cast<const void*>(absmax + (size_t)n * nb + b) : absmax,
                         ok);
      }
    } else {
      for (int i = tid; i < (a8tc::TC_ROWS << lper); i += a8tc::TC_WARPS * 32) {
        const int r = i >> lper, j = i & ((1 << lper) - 1);
        const int n = n0 + r, b = b0 + j;
        const bool ok = n < N && b < nb;
        a8tc::cp_async4(am + r * AM_PITCH + j,
                        ok ? static_cast<const void*>(absmax + (size_t)n * nb + b) : absmax, ok);
      }
    }
  }

  static __device__ __forceinline__ float scale(const float* am, int row, int j) {
    return am[row * AM_PITCH + j] * INV127;
  }
};

// ---------------------------------------------------------------------------
// __dp4a path: blocksizes the tensor-core path does not take
// ---------------------------------------------------------------------------

constexpr int WARPS = 4;  // warps per block
constexpr int ROWS = 2;   // weight rows per warp

template <int MT>
__global__ void __launch_bounds__(WARPS * 32)
w4a8_dp4a_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
                 const float* __restrict__ absmax, const float* __restrict__ sx,
                 float* __restrict__ out, int M, int N, int Kp, int bs, Table tb) {
  const int lane = threadIdx.x & 31;
  const int n0 = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * ROWS;
  const int m0 = blockIdx.y * MT;
  if (n0 >= N) return;  // warp-uniform: the whole warp leaves
  const int nb = Kp / bs;
  const size_t row_bytes = (size_t)(Kp >> 1);

  float acc[ROWS][MT];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int i = 0; i < MT; ++i) acc[r][i] = 0.f;

  for (int base = 0; base < Kp; base += 1024) {
    const int k = base + lane * 32;
    const bool active = k < Kp;  // Kp % 32 == 0: a lane's codes are all in
    uint32_t wa[ROWS][8];
    float s[ROWS][8];  // each 4-code group's block scale
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int n = n0 + r;
      const bool live = active && n < N;
      uint4 pk = make_uint4(0u, 0u, 0u, 0u);
      if (live) pk = *reinterpret_cast<const uint4*>(w + n * row_bytes + (k >> 1));
      const uint32_t words[4] = {pk.x, pk.y, pk.z, pk.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) nf4_decode8(words[j], tb, wa[r][2 * j], wa[r][2 * j + 1]);
      const float* am = absmax + (size_t)n * nb;
#pragma unroll
      for (int q = 0; q < 8; ++q) s[r][q] = live ? am[(k + 4 * q) / bs] * INV127 : 0.f;
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int m = m0 + i;
      int xv[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (active && m < M) {
        const int4* xr = reinterpret_cast<const int4*>(x + (size_t)m * Kp + k);
        const int4 xa = __ldg(xr);
        const int4 xb = __ldg(xr + 1);
        xv[0] = xa.x; xv[1] = xa.y; xv[2] = xa.z; xv[3] = xa.w;
        xv[4] = xb.x; xv[5] = xb.y; xv[6] = xb.z; xv[7] = xb.w;
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[r][i] += (float)__dp4a(xv[j], (int)wa[r][j], 0) * s[r][j];
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float v = acc[r][i];
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      const int m = m0 + i;
      const int n = n0 + r;
      if (lane == 0 && m < M && n < N) out[(size_t)m * N + n] = v * sx[m];
    }
  }
}

int launch_dp4a(const int8_t* x, const uint8_t* w, const float* am, const float* sx,
                float* out, int M, int N, int Kp, int bs, Table tb, cudaStream_t st) {
  const int mt = M >= 5 ? 8 : M >= 3 ? 4 : M;
  const dim3 block(WARPS * 32);
  const dim3 grid((N + WARPS * ROWS - 1) / (WARPS * ROWS), (M + mt - 1) / mt);
#define TBNB_DP4A(MT) \
  w4a8_dp4a_kernel<MT><<<grid, block, 0, st>>>(x, w, am, sx, out, M, N, Kp, bs, tb)
  switch (mt) {
    case 1: TBNB_DP4A(1); break;
    case 2: TBNB_DP4A(2); break;
    case 4: TBNB_DP4A(4); break;
    default: TBNB_DP4A(8); break;
  }
#undef TBNB_DP4A
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch plan of a shape: the chunks per K split (0 on the __dp4a path)
// and the scratch a launch with it needs, f32 partial sums and int counts
// that are 0 (the kernel leaves them 0), both 0 when K is not split.
extern "C" void tbnb_w4a8_plan(int M, int N, int Kp, int bs, int* cps, long long* part_floats,
                               int* counts) {
  *cps = 0;
  *part_floats = 0;
  *counts = 0;
  if (a8tc::takes(bs)) a8tc::plan<Nf4>(M, N, Kp, bs, cps, part_floats, counts);
}

// x int8 [M, Kp], w uint8 [N, Kp/2], absmax f32 [N, Kp/bs], sx f32 [M],
// out f32 [M, N], all contiguous, x and w 16-byte aligned; cps, part and
// count as tbnb_w4a8_plan gives them for this shape (part and count must not
// be in use by a launch on another stream). Kp % 32 == 0, bs % 4 == 0,
// Kp % bs == 0. t0..t3: the int8 codebook, entries 0-3, 4-7, 8-11, 12-15
// (byte 0 first). Returns cudaGetLastError() after the launch.
extern "C" int tbnb_w4a8_matmul(const void* x, const void* w, const void* absmax,
                                const void* sx, void* out, void* part, void* count, int M,
                                int N, int Kp, int bs, int cps, uint32_t t0, uint32_t t1,
                                uint32_t t2, uint32_t t3, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Table tb{t0, t1, t2, t3};
  const int8_t* xp = static_cast<const int8_t*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* ap = static_cast<const float*>(absmax);
  const float* sxp = static_cast<const float*>(sx);
  float* op = static_cast<float*>(out);
  float* pp = static_cast<float*>(part);
  int* cp = static_cast<int*>(count);
  if (!a8tc::takes(bs)) return launch_dp4a(xp, wp, ap, sxp, op, M, N, Kp, bs, tb, st);
  return a8tc::launch<Nf4>(xp, wp, ap, sxp, op, pp, cp, M, N, Kp, bs, cps, tb, st);
}
