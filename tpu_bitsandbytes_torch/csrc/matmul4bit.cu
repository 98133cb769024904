// K5: fused NF4/FP4 dequant-matmul for M up to 256, for Hopper (sm_90a).
//
// Replaces tpu_bitsandbytes/ops/matmul4bit.py:_matmul4bit_kernel
// (pallas_call at :295). Computes out[m, n] = sum_k x[m, k] * w[n, k] with
//     w[n, k] = book[code[n, k]] * absmax[n, k / bs]      (f32)
// from packed codes [N, Kp/2] (element 2j in the low nibble), absmax f32
// [N, Kp/bs] and the 16-entry f32 codebook (NF4 or FP4). bf16 mode rounds w
// to bf16 (the f32 product first, then one rounding) and takes x in bf16,
// f32 mode keeps both in f32; the products accumulate in f32 in both (out
// f32 [M, N]). The TPU kernel broadcasts absmax through a 0/1 matmul to fit
// its lane layout; here each thread multiplies by the block's absmax, which
// is what that matmul computes. Only the f32 order of the sums differs.
//
// Bound on the H100: the larger of the weight bytes (N*Kp/2 + 4*N*Kp/bs
// over 3.35 TB/s) and 2*M*N*Kp operations over the dense bf16 peak (989
// TFLOP/s); at M = 128-256 and Llama widths the operations bound.
//
// Two designs.
//
// mm4_wgmma_kernel: bf16 mode at the shapes every Llama width meets (M <=
// 256, Kp % 32 == 0, bs % 16 == 0: ops/matmul4bit.py:takes_wgmma). It
// computes out^T = W x^T, so the weight rows are wgmma's M and the tokens
// its N: M is padded up to NT = 64, 128 or 256 (one wgmma m64nNTk16 per k16
// slice) and one CTA covers 128 weight rows and all M tokens, so each code
// is read and decoded once per CTA whatever M is (the int8 ring's idea,
// a8_tc.cuh, carried to wgmma). Warpgroup 0 is the producer: one thread
// keeps 64-code stages in flight through a TMA ring (sm90.cuh; x [M, Kp]
// bf16 through a 2-D map with the 128-byte swizzle, rows past M
// zero-filled; codes [N, Kp/2] through a 2-D map, 4 KB a stage), with full
// and empty mbarriers as in K3. Warpgroups 1 and 2 each own 64 weight rows.
// The decoded weight is wgmma's register A operand, as K3 feeds p to its PV
// chain: A's fragment for a k16 slice is m16n8k16's, lane (g, t) of warp w
// holding rows 16w+g and 16w+g+8 at k = 2t..2t+1 and 2t+8..2t+9, and one
// packed byte holds k = 2j (low nibble) and 2j+1, so bytes t and t+4 of a
// slice's 8 each decode into one bf16x2 register: two lookups in the f32
// codebook in shared memory (16 entries, 16 banks: conflict-free), two
// multiplies by the row's block scale, one cvt.rn.bf16x2.f32. x is the
// shared-memory B operand, K-major, as K3's K tile. The A registers are
// double-buffered: slice j+1 is decoded while slice j's wgmma runs, after
// wgmma.wait_group 1 has freed the registers of slice j-1, and
// wgmma.fence precedes each wgmma. The block scales (one per row and k16
// slice) are plain cached loads, fetched a stage ahead. Where the N/128
// CTAs do not fill the card the K stages are split (tbnb_matmul4bit_plan,
// in the form of a8tc::plan): each split writes its f32 partial sums and
// the last split of a tile to finish adds them in split order
// (deterministic). No wgmma sits inside a branch (ptxas serializes
// the chains otherwise: info C7520), and the producer gives its
// registers to the consumers (setmaxnreg 40 / 232: at NT = 256 the
// accumulator alone is 128 f32 registers a thread). Shared memory: the
// ring, its barriers and 1,024 bytes of alignment, 99,456 / 164,992 /
// 222,304 bytes at NT = 64 / 128 / 256 (8, 8, 6 stages).
//
// mm4_bf16_kernel (bf16, the ragged shapes) and mm4_f32_kernel (f32 mode):
// one block per 64x64 output tile, a K loop over 32-wide slices whose codes
// are decoded by all threads into shared memory (bf16: four warps of
// mma.sync m16n8k16 on fragments read from shared memory; f32: 256 threads,
// 4x4 outputs each, f32 FMAs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

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

// ---- the wgmma path ----

namespace wg {

using namespace sm90;

constexpr int ROWS = 128;          // weight rows per CTA: 64 per consumer warpgroup
constexpr int KS = 64;             // codes per row and ring stage: 4 k16 slices
constexpr int CT = ROWS * KS / 2;  // one stage's packed codes: 4,096 bytes
constexpr int THREADS = 384;       // producer warpgroup + 2 consumer warpgroups
constexpr int MAX_SPLITS = 8;      // K splits per tile, at most

// Shared memory from a 1024-byte aligned base (the 128-byte swizzle repeats
// every 1024 bytes): the x tiles, the code tiles, full then empty barriers.
template <int NT>  // tokens: the N of wgmma m64nNTk16
struct Cfg {
  static constexpr int XT = NT * KS * 2;        // one stage's x tile, NT rows x 64 bf16
  static constexpr int ST = NT == 256 ? 6 : 8;  // ring stages
  static constexpr int C = ST * XT;
  static constexpr int BAR = C + ST * CT;
  static constexpr int BYTES = BAR + 16 * ST + 1024;  // + alignment
  static constexpr int NR = NT / 2;             // accumulator registers a thread
};
static_assert(Cfg<64>::BYTES == 99456 && Cfg<128>::BYTES == 164992 &&
                  Cfg<256>::BYTES == 222304,
              "the header states these sizes");

__device__ __forceinline__ uint32_t full_bar(uint32_t bar, int s) { return bar + 8 * s; }
template <int NT>
__device__ __forceinline__ uint32_t empty_bar(uint32_t bar, int s) {
  return bar + 8 * (Cfg<NT>::ST + s);
}

// d[NT/2] += A (64 x 16, registers) * B (16 x NT, smem, K-major)
template <int NT>
__device__ __forceinline__ void wgmma_ra(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (NT == 256) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " TBNB_D128
                 ", {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
                 : TBNB_ACC128(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (NT == 128) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TBNB_D64
                 ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
                 : TBNB_ACC64(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TBNB_D32
                 ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
                 : TBNB_ACC32(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

// one packed byte (bits 0-7 of b) -> bf16x2: the low nibble's element in
// the low half, each the f32 product book * scale rounded once
__device__ __forceinline__ uint32_t decode_byte(const float* cb, uint32_t b, float scale) {
  __nv_bfloat162 v = __floats2bfloat162_rn(cb[b & 15] * scale, cb[(b >> 4) & 15] * scale);
  return *reinterpret_cast<uint32_t*>(&v);
}

// grid (tiles of 128 weight rows, K splits). Split y covers the stages
// [y * cps, min((y + 1) * cps, ceil(Kp / 64))). With more than one split,
// each writes its partial sums to part ([tile][split][NR][256]) and counts
// itself in count[tile]; the last to finish adds them in split order,
// writes out and resets the count to 0 for the next call.
template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
mm4_wgmma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                 const float* __restrict__ absmax, const float* __restrict__ book,
                 float* __restrict__ out, float* __restrict__ part, int* __restrict__ count,
                 int M, int N, int Kp, int bs, int cps) {
  using L = Cfg<NT>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float cb[16];
  __shared__ int last;
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* sbase = smem_raw + (base - raw);
  const uint32_t bar = base + L::BAR;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * ROWS;
  const int st_lo = blockIdx.y * cps;
  const int nst = min(st_lo + cps, (Kp + KS - 1) / KS) - st_lo;

  if (tid < 16) cb[tid] = book[tid];
  if (tid == 0) {
    for (int s = 0; s < L::ST; ++s) {
      mbar_init(full_bar(bar, s), 1);
      mbar_init(empty_bar<NT>(bar, s), 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      for (int i = 0; i < nst; ++i) {
        const int s = i % L::ST;
        const int k0 = (st_lo + i) * KS;
        mbar_wait(empty_bar<NT>(bar, s), ((i / L::ST) & 1) ^ 1);
        mbar_expect_tx(full_bar(bar, s), L::XT + CT);
        tma_load_2d(base + s * L::XT, &tx, full_bar(bar, s), k0, 0);
        tma_load_2d(base + L::C + s * CT, &tw, full_bar(bar, s), k0 / 2, n0);
      }
    }
    return;
  }

  // ---- consumers: 64 weight rows per warpgroup ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int ct = tid - 128;
  const int warp = (ct >> 5) & 3, lane = ct & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (ct >> 7) * 64 + warp * 16 + g;  // this thread's rows r0 and r0 + 8
  const uint32_t sh = 8 * t;                      // byte t of a 4-byte word
  const int nb = Kp / bs, bs16 = bs / 16;
  // rows past N read row N - 1's scales (their codes are zero-filled and
  // their outputs dropped); slices past Kp the last block's (x is zero there)
  const float* am0 = absmax + (size_t)min(n0 + r0, N - 1) * nb;
  const float* am1 = absmax + (size_t)min(n0 + r0 + 8, N - 1) * nb;
  int pf_blk = st_lo * 4 / bs16, pf_pos = st_lo * 4 % bs16;  // next k16 slice to fetch
  float sc[2][4] = {}, sn[2][4] = {};  // rows r0, r0 + 8: this stage's scales, the next's
  auto fetch = [&](float (&d)[2][4]) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int b = min(pf_blk, nb - 1);
      d[0][s] = __ldg(am0 + b);
      d[1][s] = __ldg(am1 + b);
      if (++pf_pos == bs16) {
        pf_pos = 0;
        ++pf_blk;
      }
    }
  };
  // slice s of ring stage `stage` into the A fragment: bytes t and t+4 of
  // rows r0 (a[0], a[2]) and r0 + 8 (a[1], a[3])
  auto decode = [&](uint32_t (&a)[4], int stage, int s) {
    const uint8_t* c = sbase + L::C + stage * CT + s * 8;
    const uint2 w0 = *reinterpret_cast<const uint2*>(c + r0 * 32);
    const uint2 w1 = *reinterpret_cast<const uint2*>(c + (r0 + 8) * 32);
    a[0] = decode_byte(cb, w0.x >> sh, sc[0][s]);
    a[1] = decode_byte(cb, w1.x >> sh, sc[1][s]);
    a[2] = decode_byte(cb, w0.y >> sh, sc[0][s]);
    a[3] = decode_byte(cb, w1.y >> sh, sc[1][s]);
  };

  float acc[L::NR];
#pragma unroll
  for (int i = 0; i < L::NR; ++i) acc[i] = 0.f;
  uint32_t a[2][4];  // slice s of a stage in a[s & 1]
  fetch(sc);
  fetch(sn);
  mbar_wait(full_bar(bar, 0), 0);
  decode(a[0], 0, 0);
  for (int i = 0; i < nst; ++i) {
    const int stage = i % L::ST;
    const uint32_t xt = base + stage * L::XT;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      fence_regs<L::NR>(acc);
      wg_fence();
      wgmma_ra<NT>(acc, a[s & 1], sw128(xt + s * 32, 16, 1024));
      wg_commit();
      wg_wait<1>();  // the slice before is done: its A registers and, at s = 0,
                     // the stage before are free
      if (s == 0 && i > 0 && lane == 0) mbar_arrive(empty_bar<NT>(bar, (i - 1) % L::ST));
      if (s < 3) {
        decode(a[(s + 1) & 1], stage, s + 1);
      } else if (i + 1 < nst) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[r][j] = sn[r][j];
        fetch(sn);
        mbar_wait(full_bar(bar, (i + 1) % L::ST), ((i + 1) / L::ST) & 1);
        decode(a[0], (i + 1) % L::ST, 0);
      }
    }
  }
  wg_wait<0>();
  fence_regs<L::NR>(acc);

  const int splits = gridDim.y;
  if (splits > 1) {
    constexpr int PART = 256 * L::NR;  // partial sums per split
    float* tp = part + (size_t)blockIdx.x * splits * PART;
#pragma unroll
    for (int i = 0; i < L::NR; ++i) tp[blockIdx.y * PART + i * 256 + ct] = acc[i];
    __threadfence();
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (ct == 0) last = atomicAdd(count + blockIdx.x, 1) == splits - 1;
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (!last) return;
    __threadfence();
    // split by split, all of a split's loads in flight at once (a load
    // latency per split, not per register): 0 + p0 + p1 + ... in order
#pragma unroll
    for (int i = 0; i < L::NR; ++i) acc[i] = 0.f;
    for (int r = 0; r < splits; ++r) {
      const float* src = tp + r * PART + ct;
#pragma unroll
      for (int i = 0; i < L::NR; ++i) acc[i] += __ldcg(src + i * 256);
    }
    if (ct == 0) count[blockIdx.x] = 0;
  }
  // acc[4j + e]: weight row r0 + 8 * (e >> 1), token 8j + 2t + (e & 1)
#pragma unroll
  for (int j = 0; j < NT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + r0 + 8 * (e >> 1), m = 8 * j + 2 * t + (e & 1);
      if (m < M && n < N) out[(size_t)m * N + n] = acc[4 * j + e];
    }
}

inline bool takes(int M, int Kp, int bs) {
  return M >= 1 && M <= 256 && Kp % 32 == 0 && bs >= 16 && bs % 16 == 0 && Kp % bs == 0;
}

inline int nt_of(int M) { return M <= 64 ? 64 : M <= 128 ? 128 : 256; }

// sets the kernel's dynamic shared memory limit once; CTAs of it that fit
// one SM (in *per_sm, when given)
template <int NT>
int prepare(int* per_sm) {
  static int err = -1, n = 0;
  if (err < 0) {
    err = static_cast<int>(cudaFuncSetAttribute(
        mm4_wgmma_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<NT>::BYTES));
    if (err == 0)
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, mm4_wgmma_kernel<NT>, THREADS,
                                                    Cfg<NT>::BYTES);
    if (n <= 0) n = 1;
  }
  if (per_sm != nullptr) *per_sm = n;
  return err;
}

inline int slots(int M) {
  int n = 1;
  switch (nt_of(M)) {
    case 64: prepare<64>(&n); break;
    case 128: prepare<128>(&n); break;
    default: prepare<256>(&n); break;
  }
  return n * num_sms();
}

template <int NT>
int launch(const void* x, const void* w, const float* am, const float* book, float* out,
           float* part, int* count, int M, int N, int Kp, int bs, int cps, cudaStream_t st) {
  const int e = prepare<NT>(nullptr);
  if (e != 0) return e;
  EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tx, tw;
  const cuuint64_t xdims[2] = {(cuuint64_t)Kp, (cuuint64_t)M};
  const cuuint64_t xstride[1] = {(cuuint64_t)Kp * 2};
  const cuuint32_t xbox[2] = {KS, NT};
  const cuuint64_t wdims[2] = {(cuuint64_t)Kp / 2, (cuuint64_t)N};
  const cuuint64_t wstride[1] = {(cuuint64_t)Kp / 2};
  const cuuint32_t wbox[2] = {KS / 2, ROWS};
  const cuuint32_t step[2] = {1, 1};
  if (enc(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), xdims, xstride, xbox,
          step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      enc(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), wdims, wstride, wbox,
          step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_st = (Kp + KS - 1) / KS;
  const dim3 grid((N + ROWS - 1) / ROWS, (n_st + cps - 1) / cps);
  mm4_wgmma_kernel<NT><<<grid, THREADS, Cfg<NT>::BYTES, st>>>(tx, tw, am, book, out, part,
                                                             count, M, N, Kp, bs, cps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

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

// The launch plan of a shape on the wgmma path: the 64-code stages per K
// split and the scratch a launch with it needs, f32 partial sums and int
// counts that are 0 (the kernel leaves them 0), both 0 when K is not split;
// all 0 for a shape the path does not take. The CTAs of a launch run in
// waves of `slots`; the cost of a split count is its waves times (the
// stages one CTA streams + 2 for its fill and drain), plus one for the
// reduction of the partials: the least cost wins, the fewest splits on a
// tie.
extern "C" void tbnb_matmul4bit_plan(int M, int N, int Kp, int bs, int* cps,
                                     long long* part_floats, int* counts) {
  *cps = 0;
  *part_floats = 0;
  *counts = 0;
  if (!wg::takes(M, Kp, bs) || N < 1) return;
  const int n_st = (Kp + wg::KS - 1) / wg::KS;
  const int tiles = (N + wg::ROWS - 1) / wg::ROWS;
  const int sl = wg::slots(M);
  int best_per = n_st, best_cost = 0;
  for (int s = 1; s <= wg::MAX_SPLITS && s <= n_st; ++s) {
    const int per = (n_st + s - 1) / s;
    const int splits = (n_st + per - 1) / per;
    const int waves = (tiles * splits + sl - 1) / sl;
    const int cost = waves * (per + 2) + (splits > 1 ? 1 : 0);
    if (best_cost == 0 || cost < best_cost) {
      best_cost = cost;
      best_per = per;
    }
  }
  *cps = best_per;
  if ((n_st + best_per - 1) / best_per > 1) {
    *part_floats = (long long)tiles * ((n_st + best_per - 1) / best_per) * wg::ROWS *
                   wg::nt_of(M);
    *counts = tiles;
  }
}

// The wgmma path, bf16: x bf16 [M, Kp], w uint8 [N, Kp/2], absmax f32
// [N, Kp/bs], book f32 [16], out f32 [M, N], all contiguous, x and w 16-byte
// aligned; 1 <= M <= 256, Kp % 32 == 0, bs % 16 == 0, Kp % bs == 0; cps,
// part and count as tbnb_matmul4bit_plan gives them for this shape (part and
// count must not be in use by a launch on another stream). Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape it
// does not take or where a tensor map cannot be made).
extern "C" int tbnb_matmul4bit_wgmma(const void* x, const void* w, const void* absmax,
                                     const void* book, void* out, void* part, void* count,
                                     int M, int N, int Kp, int bs, int cps, void* stream) {
  if (!wg::takes(M, Kp, bs) || N < 1 || cps <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ap = static_cast<const float*>(absmax);
  const float* bp = static_cast<const float*>(book);
  float* op = static_cast<float*>(out);
  float* pp = static_cast<float*>(part);
  int* cp = static_cast<int*>(count);
#define TBNB_MM4WG(NT) wg::launch<NT>(x, w, ap, bp, op, pp, cp, M, N, Kp, bs, cps, st)
  switch (wg::nt_of(M)) {
    case 64: return TBNB_MM4WG(64);
    case 128: return TBNB_MM4WG(128);
    default: return TBNB_MM4WG(256);
  }
#undef TBNB_MM4WG
}
