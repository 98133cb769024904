// The int8 tensor-core block product shared by K4 (w4a8_matmul.cu, packed
// NF4 codes) and K1 (int4_matmul.cu, the int4 runtime cache), for Hopper.
//
//     out[m, n] = sx[m] * sum_b s(b, n) * dot_i32(x[m, blk b], W[n, blk b])
//
// x int8 [M, Kp] (A8 row codes), W 4-bit codes packed two per byte [N, Kp/2]
// (element 2j in the low nibble), sx f32 [M]. A policy P says how a packed
// word decodes to int8 and where the block scale s(b, n) lives:
//   P::Arg                 kernel argument the decode needs (K4's codebook);
//   P::decode8(v, arg, lo, hi)
//                          eight codes (bits 0-3 first) -> int8x4 words, codes
//                          0-3 in lo and 4-7 in hi, byte i for code i;
//   P::load_scales(dst, scales, c, n0, N, Kp, lbs)
//                          cp.async the scales chunk c needs for rows n0..n0+63
//                          into a stage's SC_STAGE bytes;
//   P::scale(sc, row, j)   the f32 factor of block j of the chunk for row.
// Each block's int32 sum is scaled by one f32 multiply-add and the row scale
// multiplies last, so only the f32 order of the block sums can differ from
// the TPU kernels'.
//
// Design (blocksizes that are powers of two from 32 up). The block dots run
// on the int8 tensor cores, mma.sync m16n8k32 (s8 x s8 -> s32), with the
// weights as the A operand and the activations as B: one warp owns 16 weight
// rows, one n8 tile is 8 activation rows, so decode M = 8 is one tile and the
// 32/64 prefill buckets are 4/8 tiles over the same decoded A fragment (the
// codes are read and decoded once, whatever M). In a k32 step lane (g, t)
// holds the packed word at bytes 4t..4t+3 of rows g and g+8 (codes 8t..8t+7),
// decoded to a0/a1 (the low four codes of rows g/g+8) and a2/a3 (the high
// four); B holds x[8*tile + g][8t..8t+7]. So the MMA sees K permuted inside
// each 32-code window, identically in A and B: the int32 sum is the same. A
// block's MMA chain starts from the bits of 1.5 * 2^23, so its exact int32
// sum reads as a float with one subtraction; after bs/32 steps it is scaled
// into f32 (blocks longer than a 256-code chunk keep their int32 sum across
// chunks and convert it once).
// Codes, activations and scales arrive through a 3-stage cp.async ring
// (16-byte copies, one chunk of 256 codes x 64 weight rows per stage, row
// pitches padded so the fragment reads are free of bank conflicts): two
// chunks are in flight while one is decoded. The ring takes 3 x (11,264 +
// 2,304 x MT) bytes of dynamic shared memory, MT = the n8 tiles of a block:
// 40,704 at M <= 8, 47,616 at M <= 16, 61,440 at M <= 32, 89,088 above.
// Matrices with few row tiles are split along K, the split count chosen once
// per shape (a8tc::plan) so that the blocks fill whole waves of the SMs; each
// split writes its f32 partial sums, and the last split of a row tile to
// finish adds them in split order (deterministic, whatever the order of
// finishing) and applies sx.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace a8tc {

constexpr int TC_WARPS = 4;
constexpr int TC_ROWS = 16 * TC_WARPS;  // weight rows per block
constexpr int LKC = 8;
constexpr int KC = 1 << LKC;            // codes per chunk (one ring stage): 256
constexpr int MAX_SPLITS = 8;           // K splits per row tile, at most
constexpr int W_PITCH = KC / 2 + 16;    // 144 B: rows g, g+8 on distinct banks
constexpr int X_PITCH = KC + 32;        // 288 B: 8-byte reads conflict-free
constexpr int W_STAGE = TC_ROWS * W_PITCH;
constexpr int SC_STAGE = TC_ROWS * (KC / 32) * 4;  // a scale per row and 32 codes, at most

__host__ __device__ constexpr int stage_bytes(int mt) {
  return W_STAGE + SC_STAGE + mt * 8 * X_PITCH;
}

constexpr int STAGES = 3;  // ring stages: 5 blocks fit an SM at M <= 8, 2 at M = 64
static_assert(STAGES * stage_bytes(1) == 40704 && STAGES * stage_bytes(8) == 89088,
              "the header states these sizes");

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(full ? 4 : 0) : "memory");
}

// A block of at most 256 codes sums to |v| < 256 * 127 * 127 < 2^22, so its
// MMA chain starts from the bits of 2^23 + 2^22 (MAGIC): the int32 result
// read as a float is then exactly MAGIC_F + v, and one subtraction gives v.
constexpr int MAGIC = 0x4B400000;
constexpr float MAGIC_F = 12582912.0f;

// c = a * b + seed (each of the four accumulators starts at seed)
__device__ __forceinline__ void mma_s8_from(int* c, const uint32_t* a, uint32_t b0, uint32_t b1,
                                            int seed) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(seed));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Chunk c (codes c*KC ..) of weight rows n0.. and activation rows m0.. into
// ring stage `st`; what lies past N, M, Kp or the last block is zero-filled.
template <class P, int MT>
__device__ __forceinline__ void load_chunk(uint8_t* st, const int8_t* x, const uint8_t* w,
                                           const float* scales, int c, int n0, int m0,
                                           int M, int N, int Kp, int lbs) {
  const int tid = threadIdx.x;
  const int kb0 = c * (KC / 2);  // byte offset in a weight row
  const int row_bytes = Kp >> 1;
  for (int i = tid; i < TC_ROWS * (KC / 32); i += TC_WARPS * 32) {
    const int r = i / (KC / 32), seg = i % (KC / 32);
    const int n = n0 + r, kb = kb0 + seg * 16;
    const bool ok = n < N && kb < row_bytes;
    cp_async16(st + r * W_PITCH + seg * 16,
               ok ? static_cast<const void*>(w + (size_t)n * row_bytes + kb) : w, ok);
  }
  P::load_scales(reinterpret_cast<float*>(st + W_STAGE), scales, c, n0, N, Kp, lbs);
  uint8_t* xs = st + W_STAGE + SC_STAGE;
  for (int i = tid; i < MT * 8 * (KC / 16); i += TC_WARPS * 32) {
    const int r = i / (KC / 16), seg = i % (KC / 16);
    const int m = m0 + r, k = c * KC + seg * 16;
    const bool ok = m < M && k < Kp;
    cp_async16(xs + r * X_PITCH + seg * 16,
               ok ? static_cast<const void*>(x + (size_t)m * Kp + k) : x, ok);
  }
}

// grid (row tiles of 64, K splits, M groups of 64). Split s covers the
// chunks [s * cps, min((s + 1) * cps, n_chunks)); cps is a whole number of
// blocks when a block spans chunks. Each split of a row tile writes its f32
// partial sums to `part` ([tile][split][MT * 8][TC_ROWS]) and counts itself
// in `count[tile]`; the last one to finish adds the partials in split order
// (deterministic whatever the order of finishing), applies sx, writes out
// and resets the count to 0 for the next call. LSPB: log2 of the k32 steps
// per block (0-3: 32-256 codes), or 4 for blocks longer than a chunk.
// At M <= 8 the ring leaves room for 5 blocks per SM: registers are capped
// so that 5 fit too.
template <class P, int MT, int LSPB>
__global__ void __launch_bounds__(TC_WARPS * 32, MT == 1 ? 5 : 1)
tc_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
          const float* __restrict__ scales, const float* __restrict__ sx,
          float* __restrict__ out, float* __restrict__ part, int* __restrict__ count,
          int M, int N, int Kp, int lbs, int cps, typename P::Arg arg) {
  constexpr bool LONG = LSPB > LKC - 5;
  constexpr int SPB = LONG ? KC / 32 : 1 << LSPB;  // k32 steps per block (per chunk if LONG)
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * TC_ROWS, m0 = blockIdx.z * 64;
  const int n_chunks = (Kp + KC - 1) / KC;
  const int c_lo = blockIdx.y * cps;
  const int c_hi = min(c_lo + cps, n_chunks);
  const int nc = c_hi - c_lo;
  const int sbytes = stage_bytes(MT);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nc)
      load_chunk<P, MT>(smem + s * sbytes, x, w, scales, c_lo + s, n0, m0, M, N, Kp, lbs);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  float acc[MT][4];
  int ci[MT][4];  // the open block's int32 sums (from MAGIC unless LONG)
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[i][e] = 0.f;
      ci[i][e] = 0;
    }
  // a long block ends with the chunk c where (c + 1) & cmask == 0
  const int cmask = LONG ? (1 << (lbs - LKC)) - 1 : 0;
  const int rw = warp * 16 + g;

  for (int i = 0; i < nc; ++i) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 2) : "memory");
    __syncthreads();  // chunk i landed; every warp is done with stage (i - 1)
    if (i + STAGES - 1 < nc)
      load_chunk<P, MT>(smem + ((i + STAGES - 1) % STAGES) * sbytes, x, w, scales,
                        c_lo + i + STAGES - 1, n0, m0, M, N, Kp, lbs);
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    const uint8_t* st = smem + (i % STAGES) * sbytes;
    const uint8_t* wr = st + rw * W_PITCH + 4 * t;
    const float* sc = reinterpret_cast<const float*>(st + W_STAGE);
    const uint8_t* xr = st + W_STAGE + SC_STAGE + g * X_PITCH + 8 * t;
    const bool long_end = LONG && ((c_lo + i + 1) & cmask) == 0;
#pragma unroll
    for (int s = 0; s < KC / 32; ++s) {
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wr + s * 16);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wr + 8 * W_PITCH + s * 16);
      uint32_t a[4];  // rows g, g+8 codes 8t..8t+3, then 8t+4..8t+7
      P::decode8(w0, arg, a[0], a[2]);
      P::decode8(w1, arg, a[1], a[3]);
#pragma unroll
      for (int nt = 0; nt < MT; ++nt) {
        const uint2 b = *reinterpret_cast<const uint2*>(xr + nt * 8 * X_PITCH + s * 32);
        if (!LONG && s % SPB == 0)
          mma_s8_from(ci[nt], a, b.x, b.y, MAGIC);
        else
          mma_s8(ci[nt], a, b.x, b.y);
      }
      if ((s + 1) % SPB == 0 && (!LONG || long_end)) {
        const int j = LONG ? 0 : s / SPB;
        const float s0 = P::scale(sc, rw, j), s1 = P::scale(sc, rw + 8, j);
#pragma unroll
        for (int nt = 0; nt < MT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v = LONG ? (float)ci[nt][e] : __int_as_float(ci[nt][e]) - MAGIC_F;
            acc[nt][e] += v * (e < 2 ? s0 : s1);
            if (LONG) ci[nt][e] = 0;
          }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  const int splits = gridDim.y;
  if (splits > 1) {
    constexpr int PART = MT * 8 * TC_ROWS;  // partial sums per split
    const int tile = blockIdx.z * gridDim.x + blockIdx.x;
    float* tile_part = part + (size_t)tile * splits * PART;
#pragma unroll
    for (int nt = 0; nt < MT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tile_part[blockIdx.y * PART + (nt * 8 + 2 * t + (e & 1)) * TC_ROWS + rw + (e >> 1) * 8] =
            acc[nt][e];
    __threadfence();
    __syncthreads();
    __shared__ int last;
    if (threadIdx.x == 0) last = atomicAdd(count + tile, 1) == splits - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
#pragma unroll
    for (int nt = 0; nt < MT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = (nt * 8 + 2 * t + (e & 1)) * TC_ROWS + rw + (e >> 1) * 8;
        float v = 0.f;
        for (int r = 0; r < splits; ++r) v += __ldcg(tile_part + r * PART + idx);
        acc[nt][e] = v;
      }
    if (threadIdx.x == 0) count[tile] = 0;
  }
#pragma unroll
  for (int nt = 0; nt < MT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + rw + (e >> 1) * 8;
      const int m = m0 + nt * 8 + 2 * t + (e & 1);
      if (n < N && m < M) out[(size_t)m * N + n] = acc[nt][e] * sx[m];
    }
}

inline bool takes(int bs) { return bs >= 32 && (bs & (bs - 1)) == 0; }

using sm90::num_sms;

inline int mt_of(int M) {
  const int m = M < 64 ? M : 64;
  return m <= 8 ? 1 : m <= 16 ? 2 : m <= 32 ? 4 : 8;
}

// blocks of the kernel that fit one SM
template <class P, int MT>
int blocks_per_sm() {
  static int n = 0;
  if (n == 0) {
    cudaFuncSetAttribute(tc_kernel<P, MT, 1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         STAGES * stage_bytes(MT));
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, tc_kernel<P, MT, 1>, TC_WARPS * 32,
                                                  STAGES * stage_bytes(MT));
    if (n <= 0) n = 1;
  }
  return n;
}

template <class P>
int slots(int M) {
  const int sms = num_sms();
  switch (mt_of(M)) {
    case 1: return sms * blocks_per_sm<P, 1>();
    case 2: return sms * blocks_per_sm<P, 2>();
    case 4: return sms * blocks_per_sm<P, 4>();
    default: return sms * blocks_per_sm<P, 8>();
  }
}

// Chunks per split, a whole number of blocks. The blocks of a launch run in
// waves of `slots`; the cost of a split count is its waves times (the
// chunks one block streams + 2 for its fill and drain), plus one for the
// reduction of the partials: the least cost wins, the fewest splits on a
// tie. (Split counts that leave a last, nearly empty wave cost double.)
template <class P>
int chunks_per_split(int M, int N, int Kp, int bs) {
  const int n_chunks = (Kp + KC - 1) / KC;
  const int unit = bs > KC ? bs / KC : 1;  // chunks per block
  const int units = (n_chunks + unit - 1) / unit;
  const int tiles = ((N + TC_ROWS - 1) / TC_ROWS) * ((M + 63) / 64);
  const int sl = slots<P>(M);
  int best_per = units, best_cost = 0;
  for (int s = 1; s <= MAX_SPLITS && s <= units; ++s) {
    const int per = (units + s - 1) / s;
    const int splits = (units + per - 1) / per;
    const int waves = (tiles * splits + sl - 1) / sl;
    const int cost = waves * (per * unit + 2) + (splits > 1 ? 1 : 0);
    if (best_cost == 0 || cost < best_cost) {
      best_cost = cost;
      best_per = per;
    }
  }
  return best_per * unit;
}

// The launch plan of a shape on the tensor-core path: the chunks per K
// split and the scratch a launch with it needs, f32 partial sums and int
// counts that are 0 (the kernel leaves them 0), both 0 when K is not split.
template <class P>
void plan(int M, int N, int Kp, int bs, int* cps, long long* part_floats, int* counts) {
  *cps = chunks_per_split<P>(M, N, Kp, bs);
  *part_floats = 0;
  *counts = 0;
  const int n_chunks = (Kp + KC - 1) / KC;
  const int splits = (n_chunks + *cps - 1) / *cps;
  if (splits == 1) return;
  const int tiles = ((N + TC_ROWS - 1) / TC_ROWS) * ((M + 63) / 64);
  *part_floats = (long long)tiles * splits * mt_of(M) * 8 * TC_ROWS;
  *counts = tiles;
}

template <class P, int MT, int LSPB>
int launch_lspb(const int8_t* x, const uint8_t* w, const float* sc, const float* sx, float* out,
                float* part, int* count, int M, int N, int Kp, int bs, int cps,
                typename P::Arg arg, cudaStream_t st) {
  const int smem = STAGES * stage_bytes(MT);
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        tc_kernel<P, MT, LSPB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const int n_chunks = (Kp + KC - 1) / KC;
  const int splits = (n_chunks + cps - 1) / cps;
  const dim3 grid((N + TC_ROWS - 1) / TC_ROWS, splits, (M + 63) / 64);
  tc_kernel<P, MT, LSPB><<<grid, TC_WARPS * 32, smem, st>>>(
      x, w, sc, sx, out, part, count, M, N, Kp, __builtin_ctz(bs), cps, arg);
  return static_cast<int>(cudaGetLastError());
}

template <class P, int MT>
int launch_mt(const int8_t* x, const uint8_t* w, const float* sc, const float* sx, float* out,
              float* part, int* count, int M, int N, int Kp, int bs, int cps,
              typename P::Arg arg, cudaStream_t st) {
#define TBNB_A8TC(LSPB) \
  launch_lspb<P, MT, LSPB>(x, w, sc, sx, out, part, count, M, N, Kp, bs, cps, arg, st)
  switch (bs) {
    case 32: return TBNB_A8TC(0);
    case 64: return TBNB_A8TC(1);
    case 128: return TBNB_A8TC(2);
    case 256: return TBNB_A8TC(3);
    default: return TBNB_A8TC(4);
  }
#undef TBNB_A8TC
}

// One launch of the tensor-core path with the plan's cps, part and count.
template <class P>
int launch(const int8_t* x, const uint8_t* w, const float* sc, const float* sx, float* out,
           float* part, int* count, int M, int N, int Kp, int bs, int cps, typename P::Arg arg,
           cudaStream_t st) {
  if (cps <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (mt_of(M)) {
    case 1: return launch_mt<P, 1>(x, w, sc, sx, out, part, count, M, N, Kp, bs, cps, arg, st);
    case 2: return launch_mt<P, 2>(x, w, sc, sx, out, part, count, M, N, Kp, bs, cps, arg, st);
    case 4: return launch_mt<P, 4>(x, w, sc, sx, out, part, count, M, N, Kp, bs, cps, arg, st);
    default: return launch_mt<P, 8>(x, w, sc, sx, out, part, count, M, N, Kp, bs, cps, arg, st);
  }
}

}  // namespace a8tc
