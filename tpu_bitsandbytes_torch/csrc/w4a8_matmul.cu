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
// Design (blocksizes that are powers of two from 32 up). The block dots run
// on the int8 tensor cores, mma.sync m16n8k32 (s8 x s8 -> s32), with the
// weights as the A operand and the activations as B: one warp owns 16 weight
// rows, one n8 tile is 8 activation rows, so decode M = 8 is one tile and the
// 32/64 prefill buckets are 4/8 tiles over the same decoded A fragment (the
// codes are read and decoded once, whatever M). In a k32 step lane (g, t)
// holds the packed word at bytes 4t..4t+3 of rows g and g+8 (codes 8t..8t+7),
// decoded to int8 by three byte permutes per four codes (a0/a1 the low four
// codes of rows g/g+8, a2/a3 the high four); B holds x[8*tile + g][8t..8t+7].
// So the MMA sees K permuted inside each 32-code window, identically in A
// and B: the int32 sum is the same. A block's MMA chain starts from the
// bits of 1.5 * 2^23, so its exact int32 sum reads as a float with one
// subtraction; after bs/32 steps it is scaled by the absmax of its rows into
// f32 (blocks longer than a 256-code chunk keep their int32 sum across
// chunks and convert it once).
// Codes, activations and absmax arrive through a 3-stage cp.async ring
// (16-byte copies, one chunk of 256 codes x 64 weight rows per stage, row
// pitches padded so the fragment reads are free of bank conflicts): two
// chunks are in flight while one is decoded. The ring takes 3 x (11,264 +
// 2,304 x MT) bytes of dynamic shared memory, MT = the n8 tiles of a block:
// 40,704 at M <= 8, 47,616 at M <= 16, 61,440 at M <= 32, 89,088 above.
// Matrices with few row tiles are split along K, the split count chosen once
// per shape (tbnb_w4a8_plan) so that the blocks fill whole waves of the SMs;
// each split writes its f32 partial sums, and the last split of a row tile
// to finish adds them in split order (deterministic, whatever the order of
// finishing) and applies sx.
//
// Other blocksizes (4-16, and multiples of 4 that are not powers of two)
// take the second path: one warp per two weight rows, __dp4a over 32 codes
// per lane, and each 4-code group's partial scaled by its block's absmax.

#include <cuda_runtime.h>
#include <stdint.h>

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
__device__ __forceinline__ void decode8(uint32_t v, const Table& tb, uint32_t& lo, uint32_t& hi) {
  const uint32_t sel = v & 0x77777777u;
  const uint32_t pick = 0x32103210u | ((v >> 1) & 0x44444444u);
  lo = __byte_perm(__byte_perm(tb.t0, tb.t1, sel), __byte_perm(tb.t2, tb.t3, sel), pick);
  const uint32_t sel_hi = sel >> 16, pick_hi = pick >> 16;
  hi = __byte_perm(__byte_perm(tb.t0, tb.t1, sel_hi), __byte_perm(tb.t2, tb.t3, sel_hi),
                   pick_hi);
}

// ---------------------------------------------------------------------------
// tensor-core path
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;
constexpr int TC_ROWS = 16 * TC_WARPS;  // weight rows per block
constexpr int LKC = 8;
constexpr int KC = 1 << LKC;            // codes per chunk (one ring stage): 256
constexpr int MAX_SPLITS = 8;           // K splits per row tile, at most
constexpr int W_PITCH = KC / 2 + 16;    // 144 B: rows g, g+8 on distinct banks
constexpr int X_PITCH = KC + 32;        // 288 B: 8-byte reads conflict-free
constexpr int AM_PITCH = KC / 32;       // absmax entries per row and chunk
constexpr int W_STAGE = TC_ROWS * W_PITCH;
constexpr int AM_STAGE = TC_ROWS * AM_PITCH * 4;

__host__ __device__ constexpr int tc_stage_bytes(int mt) {
  return W_STAGE + AM_STAGE + mt * 8 * X_PITCH;
}

constexpr int STAGES = 3;  // ring stages: 5 blocks fit an SM at M <= 8, 2 at M = 64
static_assert(STAGES * tc_stage_bytes(1) == 40704 && STAGES * tc_stage_bytes(8) == 89088,
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
template <int MT>
__device__ __forceinline__ void load_chunk(uint8_t* st, const int8_t* x, const uint8_t* w,
                                           const float* absmax, int c, int n0, int m0,
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
  float* am = reinterpret_cast<float*>(st + W_STAGE);
  const int lper = lbs < LKC ? LKC - lbs : 0;  // log2 of the blocks this chunk touches
  const int nb = Kp >> lbs, b0 = (c * KC) >> lbs;
  // 4 entries per copy where they are 16-byte aligned
  if (lper >= 2 && (nb & 3) == 0 && (reinterpret_cast<uintptr_t>(absmax) & 15) == 0) {
    for (int i = tid; i < (TC_ROWS << (lper - 2)); i += TC_WARPS * 32) {
      const int r = i >> (lper - 2), j = (i & ((1 << (lper - 2)) - 1)) << 2;
      const int n = n0 + r, b = b0 + j;
      const bool ok = n < N && b < nb;
      cp_async16(am + r * AM_PITCH + j,
                 ok ? static_cast<const void*>(absmax + (size_t)n * nb + b) : absmax, ok);
    }
  } else {
    for (int i = tid; i < (TC_ROWS << lper); i += TC_WARPS * 32) {
      const int r = i >> lper, j = i & ((1 << lper) - 1);
      const int n = n0 + r, b = b0 + j;
      const bool ok = n < N && b < nb;
      cp_async4(am + r * AM_PITCH + j,
                ok ? static_cast<const void*>(absmax + (size_t)n * nb + b) : absmax, ok);
    }
  }
  uint8_t* xs = st + W_STAGE + AM_STAGE;
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
template <int MT, int LSPB>
__global__ void __launch_bounds__(TC_WARPS * 32, MT == 1 ? 5 : 1)
w4a8_tc_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
               const float* __restrict__ absmax, const float* __restrict__ sx,
               float* __restrict__ out, float* __restrict__ part, int* __restrict__ count,
               int M, int N, int Kp, int lbs, int cps, Table tb) {
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
  const int stage_bytes = tc_stage_bytes(MT);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nc)
      load_chunk<MT>(smem + s * stage_bytes, x, w, absmax, c_lo + s, n0, m0, M, N, Kp, lbs);
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
      load_chunk<MT>(smem + ((i + STAGES - 1) % STAGES) * stage_bytes, x, w, absmax,
                     c_lo + i + STAGES - 1, n0, m0, M, N, Kp, lbs);
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    const uint8_t* st = smem + (i % STAGES) * stage_bytes;
    const uint8_t* wr = st + rw * W_PITCH + 4 * t;
    const float* am = reinterpret_cast<const float*>(st + W_STAGE) + rw * AM_PITCH;
    const uint8_t* xr = st + W_STAGE + AM_STAGE + g * X_PITCH + 8 * t;
    const bool long_end = LONG && ((c_lo + i + 1) & cmask) == 0;
#pragma unroll
    for (int s = 0; s < KC / 32; ++s) {
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wr + s * 16);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wr + 8 * W_PITCH + s * 16);
      uint32_t a[4];  // rows g, g+8 codes 8t..8t+3, then 8t+4..8t+7
      decode8(w0, tb, a[0], a[2]);
      decode8(w1, tb, a[1], a[3]);
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
        const float s0 = am[j] * INV127, s1 = am[8 * AM_PITCH + j] * INV127;
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

bool tc_takes(int bs) { return bs >= 32 && (bs & (bs - 1)) == 0; }

int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

int tc_mt(int M) {
  const int m = M < 64 ? M : 64;
  return m <= 8 ? 1 : m <= 16 ? 2 : m <= 32 ? 4 : 8;
}

// blocks of the tensor-core kernel that fit one SM
template <int MT>
int tc_blocks_per_sm() {
  static int n = 0;
  if (n == 0) {
    cudaFuncSetAttribute(w4a8_tc_kernel<MT, 1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         STAGES * tc_stage_bytes(MT));
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, w4a8_tc_kernel<MT, 1>, TC_WARPS * 32,
                                                  STAGES * tc_stage_bytes(MT));
    if (n <= 0) n = 1;
  }
  return n;
}

int tc_slots(int M) {
  const int sms = num_sms();
  switch (tc_mt(M)) {
    case 1: return sms * tc_blocks_per_sm<1>();
    case 2: return sms * tc_blocks_per_sm<2>();
    case 4: return sms * tc_blocks_per_sm<4>();
    default: return sms * tc_blocks_per_sm<8>();
  }
}

// Chunks per split, a whole number of blocks. The blocks of a launch run in
// waves of `slots`; the cost of a split count is its waves times (the
// chunks one block streams + 2 for its fill and drain), plus one for the
// reduction of the partials: the least cost wins, the fewest splits on a
// tie. (Split counts that leave a last, nearly empty wave cost double.)
int tc_cps(int M, int N, int Kp, int bs) {
  const int n_chunks = (Kp + KC - 1) / KC;
  const int unit = bs > KC ? bs / KC : 1;  // chunks per block
  const int units = (n_chunks + unit - 1) / unit;
  const int tiles = ((N + TC_ROWS - 1) / TC_ROWS) * ((M + 63) / 64);
  const int slots = tc_slots(M);
  int best_per = units, best_cost = 0;
  for (int s = 1; s <= MAX_SPLITS && s <= units; ++s) {
    const int per = (units + s - 1) / s;
    const int splits = (units + per - 1) / per;
    const int waves = (tiles * splits + slots - 1) / slots;
    const int cost = waves * (per * unit + 2) + (splits > 1 ? 1 : 0);
    if (best_cost == 0 || cost < best_cost) {
      best_cost = cost;
      best_per = per;
    }
  }
  return best_per * unit;
}

template <int MT, int LSPB>
int launch_tc(const int8_t* x, const uint8_t* w, const float* am, const float* sx, float* out,
              float* part, int* count, int M, int N, int Kp, int bs, int cps, Table tb,
              cudaStream_t st) {
  const int smem = STAGES * tc_stage_bytes(MT);
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        w4a8_tc_kernel<MT, LSPB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const int n_chunks = (Kp + KC - 1) / KC;
  const int splits = (n_chunks + cps - 1) / cps;
  const dim3 grid((N + TC_ROWS - 1) / TC_ROWS, splits, (M + 63) / 64);
  w4a8_tc_kernel<MT, LSPB><<<grid, TC_WARPS * 32, smem, st>>>(
      x, w, am, sx, out, part, count, M, N, Kp, __builtin_ctz(bs), cps, tb);
  return static_cast<int>(cudaGetLastError());
}

template <int MT>
int launch_tc_bs(const int8_t* x, const uint8_t* w, const float* am, const float* sx,
                 float* out, float* part, int* count, int M, int N, int Kp, int bs, int cps,
                 Table tb, cudaStream_t st) {
  switch (bs) {
    case 32: return launch_tc<MT, 0>(x, w, am, sx, out, part, count, M, N, Kp, bs, cps, tb, st);
    case 64: return launch_tc<MT, 1>(x, w, am, sx, out, part, count, M, N, Kp, bs, cps, tb, st);
    case 128: return launch_tc<MT, 2>(x, w, am, sx, out, part, count, M, N, Kp, bs, cps, tb, st);
    case 256: return launch_tc<MT, 3>(x, w, am, sx, out, part, count, M, N, Kp, bs, cps, tb, st);
    default: return launch_tc<MT, 4>(x, w, am, sx, out, part, count, M, N, Kp, bs, cps, tb, st);
  }
}

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
      for (int j = 0; j < 4; ++j) decode8(words[j], tb, wa[r][2 * j], wa[r][2 * j + 1]);
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
  if (!tc_takes(bs)) return;
  *cps = tc_cps(M, N, Kp, bs);
  const int n_chunks = (Kp + KC - 1) / KC;
  const int splits = (n_chunks + *cps - 1) / *cps;
  if (splits == 1) return;
  const int tiles = ((N + TC_ROWS - 1) / TC_ROWS) * ((M + 63) / 64);
  *part_floats = (long long)tiles * splits * tc_mt(M) * 8 * TC_ROWS;
  *counts = tiles;
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
  if (!tc_takes(bs)) return launch_dp4a(xp, wp, ap, sxp, op, M, N, Kp, bs, tb, st);
  if (cps <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (tc_mt(M)) {
    case 1: return launch_tc_bs<1>(xp, wp, ap, sxp, op, pp, cp, M, N, Kp, bs, cps, tb, st);
    case 2: return launch_tc_bs<2>(xp, wp, ap, sxp, op, pp, cp, M, N, Kp, bs, cps, tb, st);
    case 4: return launch_tc_bs<4>(xp, wp, ap, sxp, op, pp, cp, M, N, Kp, bs, cps, tb, st);
    default: return launch_tc_bs<8>(xp, wp, ap, sxp, op, pp, cp, M, N, Kp, bs, cps, tb, st);
  }
}
