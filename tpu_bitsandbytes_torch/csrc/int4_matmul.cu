// K1: decode matmul over the int4 runtime cache, for Hopper (sm_90a).
//
// Replaces tpu_bitsandbytes/ops/int4cache.py:_kernel (pallas_call at :155).
// Computes
//     out[m, n] = sx[m] * sum_b scale[b, n] * dot_i32(x[m, blk b], w[n, blk b])
// with x int8 [M, Kp] (the A8 row codes), w two signed nibbles per byte
// [N, Kp/2] (element 2j in the low nibble), scale f32 [Kp/bs, N] and sx f32
// [M]. Each block dot is an exact int32 sum; the f32 scaling follows the
// TPU kernel's order per block.
//
// Bound on the H100: the weight bytes. At decode M (8) the kernel reads
// N*Kp/2 + 4*N*Kp/bs bytes of weights and scales and M*Kp bytes of x,
// against 2*M*N*Kp int8 operations: a few operations per byte, far below
// the card's ~590 int8 operations per byte of HBM bandwidth.
//
// Design: one warp streams ROWS weight rows at a time, each lane loading
// 16 contiguous bytes (32 nibbles, inside one scale block) per row per
// iteration, so a warp's loads are fully coalesced 512-byte runs. The
// nibbles are sign-extended in registers into int8x4 words in K order and
// contracted with __dp4a against x, which every row of the warp shares (x is
// tiny and stays in L1). The lanes of one scale block combine their int32
// partials with shuffles before the one f32 multiply by scale[b, n]. M is
// covered MT rows per grid row (MT <= 8); larger M re-reads the weights
// from L2 once per MT rows. No tensor cores and no TMA yet: those are for
// the PRs that make this kernel fast.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;  // warps per block
constexpr int ROWS = 2;   // weight rows per warp

// Four 4-bit two's-complement values, one in the low half of each byte ->
// four int8 values. (v & 0x08) * 0x1E sets the high half of a negative
// byte to 0xF without carrying into the next byte.
__device__ __forceinline__ uint32_t sext_nibbles(uint32_t v) {
  return v | ((v & 0x08080808u) * 0x1Eu);
}

template <int MT>
__global__ void __launch_bounds__(WARPS * 32)
int4_mm_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
               const float* __restrict__ scales, const float* __restrict__ sx,
               float* __restrict__ out, int M, int N, int Kp, int bs) {
  const int lane = threadIdx.x & 31;
  const int n0 = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * ROWS;
  const int m0 = blockIdx.y * MT;
  if (n0 >= N) return;  // warp-uniform: the whole warp leaves
  const int lpb = bs >> 5;  // lanes per scale block
  const bool leader = (lane & (lpb - 1)) == 0;
  const size_t row_bytes = (size_t)(Kp >> 1);

  float acc[ROWS][MT];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int i = 0; i < MT; ++i) acc[r][i] = 0.f;

  for (int base = 0; base < Kp; base += 1024) {
    const int k = base + lane * 32;
    const bool active = k < Kp;
    const int b = k / bs;
    uint32_t wa[ROWS][8];
    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int n = n0 + r;
      const bool live = active && n < N;
      uint4 pk = make_uint4(0u, 0u, 0u, 0u);
      if (live) pk = *reinterpret_cast<const uint4*>(w + n * row_bytes + (k >> 1));
      const uint32_t words[4] = {pk.x, pk.y, pk.z, pk.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // byte i of a word holds elements 2i (low) and 2i+1 (high)
        const uint32_t lo = sext_nibbles(words[j] & 0x0F0F0F0Fu);
        const uint32_t hi = sext_nibbles((words[j] >> 4) & 0x0F0F0F0Fu);
        wa[r][2 * j] = __byte_perm(lo, hi, 0x5140);      // e0 e1 e2 e3
        wa[r][2 * j + 1] = __byte_perm(lo, hi, 0x7362);  // e4 e5 e6 e7
      }
      s[r] = (live && leader) ? scales[(size_t)b * N + n] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int m = m0 + i;
      int d[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) d[r] = 0;
      if (active && m < M) {
        const int4* xr = reinterpret_cast<const int4*>(x + (size_t)m * Kp + k);
        const int4 xa = __ldg(xr);
        const int4 xb = __ldg(xr + 1);
        const int xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int j = 0; j < 8; ++j) d[r] = __dp4a(xv[j], (int)wa[r][j], d[r]);
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        for (int o = 1; o < lpb; o <<= 1) d[r] += __shfl_xor_sync(0xffffffffu, d[r], o);
        acc[r][i] += (float)d[r] * s[r];  // s is 0 off the block's leader lane
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

// x int8 [M, Kp], w uint8 [N, Kp/2], scales f32 [Kp/bs, N], sx f32 [M],
// out f32 [M, N], all contiguous. Kp % bs == 0; bs a power of two in
// [32, 1024]. Returns cudaGetLastError() after the launch.
extern "C" int tbnb_int4_matmul(const void* x, const void* w, const void* scales,
                                const void* sx, void* out, int M, int N, int Kp,
                                int bs, void* stream) {
  const int mt = M >= 5 ? 8 : M >= 3 ? 4 : M;
  const dim3 block(WARPS * 32);
  const dim3 grid((N + WARPS * ROWS - 1) / (WARPS * ROWS), (M + mt - 1) / mt);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* sp = static_cast<const float*>(scales);
  const float* sxp = static_cast<const float*>(sx);
  float* op = static_cast<float*>(out);
  switch (mt) {
    case 1: int4_mm_kernel<1><<<grid, block, 0, st>>>(xp, wp, sp, sxp, op, M, N, Kp, bs); break;
    case 2: int4_mm_kernel<2><<<grid, block, 0, st>>>(xp, wp, sp, sxp, op, M, N, Kp, bs); break;
    case 4: int4_mm_kernel<4><<<grid, block, 0, st>>>(xp, wp, sp, sxp, op, M, N, Kp, bs); break;
    default: int4_mm_kernel<8><<<grid, block, 0, st>>>(xp, wp, sp, sxp, op, M, N, Kp, bs); break;
  }
  return static_cast<int>(cudaGetLastError());
}
