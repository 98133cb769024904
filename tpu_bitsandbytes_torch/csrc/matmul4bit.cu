// K5: fused NF4/FP4 dequant-matmul for M up to 256, for Hopper (sm_90a).
//
// Replaces tpu_bitsandbytes/ops/matmul4bit.py:_matmul4bit_kernel
// (pallas_call at :295). Computes out[m, n] = sum_k x[m, k] * w[n, k] with
//     w[n, k] = book[code[n, k]] * absmax[n, k / bs]      (f32)
// from packed codes [N, Kp/2] (element 2j in the low nibble), absmax f32
// [N, Kp/bs] and the 16-entry f32 codebook (NF4 or FP4). bf16 mode rounds w
// to bf16 and takes x in bf16, f32 mode keeps both in f32; the products
// accumulate in f32 in both (out f32 [M, N]). The TPU kernel broadcasts
// absmax through a 0/1 matmul to fit its lane layout; here each thread
// multiplies by the block's absmax, which is what that matmul computes.
//
// Bound on the H100: at M = 64-256 the larger of the weight bytes
// (N*Kp/2 + 4*N*Kp/bs over 3.35 TB/s) and 2*M*N*Kp operations over the
// dense bf16 peak (989 TFLOP/s); at M = 256 and 13B widths the operations
// bound, by ~3x.
//
// Design: one block per 64x64 output tile, a K loop over 32-wide slices.
// Each slice's packed codes are decoded by all threads into shared memory,
// in bf16 (bf16 mode) or f32 (f32 mode), so the dequantized weight never
// reaches device memory. bf16 mode: four warps, each a 32x32 quarter of
// the tile, run mma.sync m16n8k16 (bf16 x bf16 -> f32) on fragments read
// from shared memory. f32 mode: 256 threads, 4x4 outputs each, f32 FMAs.
// No double buffering, TMA or wgmma yet: those are for the PRs that make
// this kernel fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LDS = BK + 8;  // padded bf16 row: fragment loads avoid bank conflicts

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// absmax of element k of row n
__device__ __forceinline__ float scale_at(const float* am_row, int k, int bs) {
  return am_row[k / bs];
}

__global__ void __launch_bounds__(128)
mm4_bf16_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
                const float* __restrict__ absmax, const float* __restrict__ book,
                float* __restrict__ out, int M, int N, int Kp, int bs) {
  __shared__ __align__(16) __nv_bfloat16 As[BM][LDS];
  __shared__ __align__(16) __nv_bfloat16 Bs[BN][LDS];
  __shared__ float cb[16];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m_blk = blockIdx.y * BM, n_blk = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t = lane & 3;
  const int nb = Kp / bs;
  const bool vec = (Kp & 31) == 0;  // whole 32-wide slices, 16-byte rows
  if (tid < 16) cb[tid] = book[tid];

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  __syncthreads();

  for (int k0 = 0; k0 < Kp; k0 += BK) {
    // x slice: 64 rows x 32 bf16, 16 bytes per thread-chunk
#pragma unroll
    for (int c = tid; c < BM * 4; c += 128) {
      const int row = c >> 2, part = (c & 3) * 8;
      const int gm = m_blk + row, gk = k0 + part;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gm < M) {
        const __nv_bfloat16* src = x + (size_t)gm * Kp + gk;
        if (vec) {
          v = *reinterpret_cast<const uint4*>(src);
        } else {
          union { uint4 u; unsigned short h[8]; } tmp;
#pragma unroll
          for (int e = 0; e < 8; ++e)
            tmp.h[e] = gk + e < Kp ? __bfloat16_as_ushort(src[e]) : 0;
          v = tmp.u;
        }
      }
      *reinterpret_cast<uint4*>(&As[row][part]) = v;
    }
    // weight slice: 64 rows x 32 codes; thread -> row tid/2, 16 codes
    {
      const int row = tid >> 1, kk = (tid & 1) * 16;
      const int n = n_blk + row, k = k0 + kk;
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(&Bs[row][kk]);
      if (n < N) {
        const uint8_t* src = w + (size_t)n * (Kp >> 1) + (k >> 1);
        const float* am = absmax + (size_t)n * nb;
        union { uint2 u; uint8_t b[8]; } pk;
        if (vec) {
          pk.u = *reinterpret_cast<const uint2*>(src);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) pk.b[j] = k + 2 * j < Kp ? src[j] : 0;
        }
        const uint8_t* bytes = pk.b;
        const bool one_block = bs % 16 == 0;
        const float s0 = k < Kp ? scale_at(am, k, bs) : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int ke = k + 2 * j;
          float s = s0;
          if (!one_block) s = ke < Kp ? scale_at(am, ke, bs) : 0.f;
          const float lo = cb[bytes[j] & 15] * s;
          const float hi = cb[bytes[j] >> 4] * s;   // same block: bs is even
          dst[j] = ke < Kp ? __floats2bfloat162_rn(lo, hi) : __floats2bfloat162_rn(0.f, 0.f);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) dst[j] = __floats2bfloat162_rn(0.f, 0.f);
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + mi * 16 + g, c = ks + 2 * t;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(&As[r][c]);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][c]);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(&As[r][c + 8]);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][c + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int r = wn + ni * 8 + g, c = ks + 2 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&Bs[r][c]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&Bs[r][c + 8]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][ni], a[mi], b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m_blk + wm + mi * 16 + g + 8 * h;
        const int n = n_blk + wn + ni * 8 + 2 * t;
        if (m < M) {
          if (n < N) out[(size_t)m * N + n] = acc[mi][ni][2 * h];
          if (n + 1 < N) out[(size_t)m * N + n + 1] = acc[mi][ni][2 * h + 1];
        }
      }
}

constexpr int FK = 16;  // f32 mode: K slice

__global__ void __launch_bounds__(256)
mm4_f32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ w,
               const float* __restrict__ absmax, const float* __restrict__ book,
               float* __restrict__ out, int M, int N, int Kp, int bs) {
  __shared__ __align__(16) float As[FK][BM + 4];  // x slice, k-major
  __shared__ __align__(16) float Bs[FK][BN + 4];  // dequantized w slice, k-major
  __shared__ float cb[16];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // 4 columns of N, 4 rows of M each
  const int m_blk = blockIdx.y * BM, n_blk = blockIdx.x * BN;
  const int nb = Kp / bs;
  if (tid < 16) cb[tid] = book[tid];
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  __syncthreads();

  for (int k0 = 0; k0 < Kp; k0 += FK) {
#pragma unroll
    for (int e = tid; e < BM * FK; e += 256) {
      const int row = e / FK, kk = e % FK;
      const int m = m_blk + row, k = k0 + kk;
      As[kk][row] = (m < M && k < Kp) ? x[(size_t)m * Kp + k] : 0.f;
    }
    {  // 64 rows x 16 codes: thread -> row tid/4, 4 codes (2 bytes)
      const int row = tid >> 2, kk = (tid & 3) * 4;
      const int n = n_blk + row;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = k0 + kk + 2 * j;
        float lo = 0.f, hi = 0.f;
        if (n < N && k < Kp) {
          const uint8_t byte = w[(size_t)n * (Kp >> 1) + (k >> 1)];
          const float s = scale_at(absmax + (size_t)n * nb, k, bs);
          lo = cb[byte & 15] * s;
          hi = cb[byte >> 4] * s;
        }
        Bs[kk + 2 * j][row] = lo;
        Bs[kk + 2 * j + 1][row] = hi;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m_blk + ty * 4 + i, n = n_blk + tx * 4 + j;
      if (m < M && n < N) out[(size_t)m * N + n] = acc[i][j];
    }
}

}  // namespace

// x [M, Kp] (bf16 when bf16_mode, else f32), w uint8 [N, Kp/2], absmax f32
// [N, Kp/bs], book f32 [16], out f32 [M, N], all contiguous; bs even,
// Kp % bs == 0. Returns cudaGetLastError() after the launch.
extern "C" int tbnb_matmul4bit(const void* x, const void* w, const void* absmax,
                               const void* book, void* out, int M, int N, int Kp,
                               int bs, int bf16_mode, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* ap = static_cast<const float*>(absmax);
  const float* bp = static_cast<const float*>(book);
  float* op = static_cast<float*>(out);
  if (bf16_mode)
    mm4_bf16_kernel<<<grid, 128, 0, st>>>(static_cast<const __nv_bfloat16*>(x), wp, ap,
                                          bp, op, M, N, Kp, bs);
  else
    mm4_f32_kernel<<<grid, 256, 0, st>>>(static_cast<const float*>(x), wp, ap, bp, op,
                                         M, N, Kp, bs);
  return static_cast<int>(cudaGetLastError());
}
