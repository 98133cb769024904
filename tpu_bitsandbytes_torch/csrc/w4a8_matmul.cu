// K4: packed NF4 x A8 matmul at decode M, for Hopper (sm_90a).
//
// Replaces tpu_bitsandbytes/ops/w4a8.py:_w4a8_kernel (pallas_call at :141).
// Computes
//     out[m, n] = sx[m] * sum_b (absmax[n, b] * (1/127))
//                         * dot_i32(x[m, blk b], NF4_I8[code[n, blk b]])
// with x int8 [M, Kp] (the A8 row codes), w packed NF4 codes [N, Kp/2]
// (element 2j in the low nibble), absmax f32 [N, Kp/bs], sx f32 [M] and
// NF4_I8 the 16-entry int8 codebook round(NF4 * 127). The TPU kernel dots
// the even and the odd K planes apart; their sum is the same integer as
// the dot in natural K order, which this kernel takes. The block scale is a
// multiply by the f32 constant 1/127, as in the TPU kernel.
//
// Bound on the H100: the packed bytes. At decode M (8) the kernel reads
// N*Kp/2 bytes of codes and 4*N*Kp/bs of absmax against 2*M*N*Kp int8
// operations: a few operations per byte, far below the card's ~590 int8
// operations per byte of HBM bandwidth.
//
// Design: K1's loop. One warp streams ROWS weight rows at a time, each lane
// loading 16 contiguous bytes (32 codes) per row per iteration, so a warp's
// loads are coalesced 512-byte runs. A code decodes through the table held
// in four registers: two __byte_perm lookups give entries 0-7 and 8-15 for
// the low three bits of four codes, and a third picks between them by bit
// 3, so four codes cost three byte permutes in K order. The int8x4 words
// meet x (shared by every row of the warp; tiny, it stays in L1) in __dp4a.
// For a power-of-two block of 32 to 1024 codes, the lanes of one block add
// their int32 partials with shuffles before the one f32 multiply, so each
// block sum is exact, as in the TPU kernel. A block of more than 1024 codes
// spans several 1024-code iterations, each with its own exact int32 sum and
// f32 multiply-add; smaller blocks scale each 4-code group's partial. Both
// round the block's f32 sum in another order than the TPU kernel, well
// inside 1e-5 of max|out|. The blocksizes of 4-bit states are powers of
// two, so the kernel takes multiples of 4. M is covered MT rows per grid
// row; larger M re-reads the codes from L2. No tensor cores and no TMA yet:
// those are for the PRs that make it fast.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;  // warps per block
constexpr int ROWS = 2;   // weight rows per warp
constexpr float INV127 = 1.0f / 127.0f;

struct Table {
  uint32_t t0, t1, t2, t3;  // entries 0-3, 4-7, 8-11, 12-15, one per byte
};

// The four codes in the low 16 bits of v (element order: bits 0-3 first)
// -> their four int8 table values, byte i for code i.
__device__ __forceinline__ uint32_t decode4(uint32_t v, const Table& tb) {
  const uint32_t sel = v & 0x7777u;
  const uint32_t lo = __byte_perm(tb.t0, tb.t1, sel);   // entries 0-7
  const uint32_t hi = __byte_perm(tb.t2, tb.t3, sel);   // entries 8-15
  // byte i from hi where bit 3 of code i is set: selector i or 4 + i
  return __byte_perm(lo, hi, 0x3210u | ((v >> 1) & 0x4444u));
}

template <int MT>
__global__ void __launch_bounds__(WARPS * 32)
w4a8_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
            const float* __restrict__ absmax, const float* __restrict__ sx,
            float* __restrict__ out, int M, int N, int Kp, int bs, Table tb) {
  const int lane = threadIdx.x & 31;
  const int n0 = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * ROWS;
  const int m0 = blockIdx.y * MT;
  if (n0 >= N) return;  // warp-uniform: the whole warp leaves
  const int nb = Kp / bs;
  const size_t row_bytes = (size_t)(Kp >> 1);
  // whole blocks per lane group: bs a power of two >= 32
  const bool wide = bs >= 32 && (bs & (bs - 1)) == 0;
  const int lpb = wide ? min(bs >> 5, 32) : 1;  // lanes per block
  const bool leader = (lane & (lpb - 1)) == 0;

  float acc[ROWS][MT];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int i = 0; i < MT; ++i) acc[r][i] = 0.f;

  for (int base = 0; base < Kp; base += 1024) {
    const int k = base + lane * 32;
    const bool active = k < Kp;  // Kp % 32 == 0: a lane's codes are all in
    uint32_t wa[ROWS][8];
    float s[ROWS][8];  // wide: s[r][0] on the leader, else per 4-code group
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int n = n0 + r;
      const bool live = active && n < N;
      uint4 pk = make_uint4(0u, 0u, 0u, 0u);
      if (live) pk = *reinterpret_cast<const uint4*>(w + n * row_bytes + (k >> 1));
      const uint32_t words[4] = {pk.x, pk.y, pk.z, pk.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wa[r][2 * j] = decode4(words[j], tb);
        wa[r][2 * j + 1] = decode4(words[j] >> 16, tb);
      }
      const float* am = absmax + (size_t)n * nb;
      if (wide) {
        s[r][0] = (live && leader) ? am[k / bs] * INV127 : 0.f;
      } else {
#pragma unroll
        for (int g = 0; g < 8; ++g) s[r][g] = live ? am[(k + 4 * g) / bs] * INV127 : 0.f;
      }
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
      for (int r = 0; r < ROWS; ++r) {
        if (wide) {
          int d = 0;
#pragma unroll
          for (int j = 0; j < 8; ++j) d = __dp4a(xv[j], (int)wa[r][j], d);
          for (int o = 1; o < lpb; o <<= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
          acc[r][i] += (float)d * s[r][0];  // s is 0 off the block's leader lane
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[r][i] += (float)__dp4a(xv[j], (int)wa[r][j], 0) * s[r][j];
        }
      }
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

}  // namespace

// x int8 [M, Kp], w uint8 [N, Kp/2], absmax f32 [N, Kp/bs], sx f32 [M],
// out f32 [M, N], all contiguous. Kp % 32 == 0, bs % 4 == 0, Kp % bs == 0.
// t0..t3: the int8 codebook, entries 0-3, 4-7, 8-11, 12-15 (byte 0 first).
// Returns cudaGetLastError() after the launch.
extern "C" int tbnb_w4a8_matmul(const void* x, const void* w, const void* absmax,
                                const void* sx, void* out, int M, int N, int Kp,
                                int bs, uint32_t t0, uint32_t t1, uint32_t t2,
                                uint32_t t3, void* stream) {
  const int mt = M >= 5 ? 8 : M >= 3 ? 4 : M;
  const dim3 block(WARPS * 32);
  const dim3 grid((N + WARPS * ROWS - 1) / (WARPS * ROWS), (M + mt - 1) / mt);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Table tb{t0, t1, t2, t3};
  const int8_t* xp = static_cast<const int8_t*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* ap = static_cast<const float*>(absmax);
  const float* sxp = static_cast<const float*>(sx);
  float* op = static_cast<float*>(out);
  switch (mt) {
    case 1: w4a8_kernel<1><<<grid, block, 0, st>>>(xp, wp, ap, sxp, op, M, N, Kp, bs, tb); break;
    case 2: w4a8_kernel<2><<<grid, block, 0, st>>>(xp, wp, ap, sxp, op, M, N, Kp, bs, tb); break;
    case 4: w4a8_kernel<4><<<grid, block, 0, st>>>(xp, wp, ap, sxp, op, M, N, Kp, bs, tb); break;
    default: w4a8_kernel<8><<<grid, block, 0, st>>>(xp, wp, ap, sxp, op, M, N, Kp, bs, tb); break;
  }
  return static_cast<int>(cudaGetLastError());
}
