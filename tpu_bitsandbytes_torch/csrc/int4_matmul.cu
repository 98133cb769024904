// K1: decode matmul over the int4 runtime cache, for Hopper (sm_90a).
//
// Replaces tpu_bitsandbytes/ops/int4cache.py:_kernel (pallas_call at :155).
// Computes
//     out[m, n] = sx[m] * sum_b scale[b, n] * dot_i32(x[m, blk b], w[n, blk b])
// with x int8 [M, Kp] (the A8 row codes), w two signed nibbles per byte
// [N, Kp/2] (element 2j in the low nibble), scale f32 [Kp/bs, N] and sx f32
// [M]. Each block dot is an exact int32 sum; the f32 scaling follows the
// TPU kernel's order per block (acc += f32(dot) * scale[b, n], then * sx[m]),
// so only the order of the block sums can differ.
//
// Bound on the H100: the weight bytes. At decode M (8) the kernel reads
// N*Kp/2 + 4*N*Kp/bs bytes of weights and scales and M*Kp bytes of x,
// against 2*M*N*Kp int8 operations: a few operations per byte, far below
// the card's ~590 int8 operations per byte of HBM bandwidth. What the first
// design lost was latency: one warp per two rows kept ~1 KB in flight.
//
// Design: the int8 tensor-core ring of a8_tc.cuh, shared with K4 (mma.sync
// m16n8k32 with 16 weight rows per warp as A and the M activation rows as n8
// tiles over one decoded fragment; a 3-stage cp.async ring of 256-code
// chunks, so two chunks of 64 rows are in flight per block; a wave-aware
// split along K chosen once per shape by tbnb_int4_plan, whose last split
// adds the partials in split order). The decode is cheaper than K4's: the
// two's-complement nibbles sign-extend with one multiply-or per four codes
// and two byte permutes put them in element order, the same order K4's
// table decode gives, so the fragment map is K4's. The scales are K-major
// [Kp/bs, N]: a stage holds the [blocks of the chunk][64 rows] tile of them.
// Every blocksize the wrapper takes (powers of two, 32-1024) runs this path.

#include <cuda_runtime.h>
#include <stdint.h>

#include "a8_tc.cuh"

namespace {

// Four 4-bit two's-complement values, one in the low half of each byte ->
// four int8 values. (v & 0x08) * 0x1E sets the high half of a negative
// byte to 0xF without carrying into the next byte.
__device__ __forceinline__ uint32_t sext_nibbles(uint32_t v) {
  return v | ((v & 0x08080808u) * 0x1Eu);
}

struct NoArg {};

struct Int4 {
  using Arg = NoArg;

  // byte i of v holds elements 2i (low nibble) and 2i+1 (high)
  static __device__ __forceinline__ void decode8(uint32_t v, const NoArg&, uint32_t& lo,
                                                 uint32_t& hi) {
    const uint32_t ev = sext_nibbles(v & 0x0F0F0F0Fu);         // e0 e2 e4 e6
    const uint32_t od = sext_nibbles((v >> 4) & 0x0F0F0F0Fu);  // e1 e3 e5 e7
    lo = __byte_perm(ev, od, 0x5140);                          // e0 e1 e2 e3
    hi = __byte_perm(ev, od, 0x7362);                          // e4 e5 e6 e7
  }

  // scale[blocks of chunk c][n0 .. n0+63] -> sc[j * TC_ROWS + row]
  static __device__ __forceinline__ void load_scales(float* sc, const float* scales, int c,
                                                     int n0, int N, int Kp, int lbs) {
    using a8tc::LKC;
    using a8tc::TC_ROWS;
    const int tid = threadIdx.x;
    const int lper = lbs < LKC ? LKC - lbs : 0;  // log2 of the blocks this chunk touches
    const int nb = Kp >> lbs, b0 = (c * a8tc::KC) >> lbs;
    // 4 rows per copy where each block's row of N is 16-byte aligned
    if ((N & 3) == 0 && (reinterpret_cast<uintptr_t>(scales) & 15) == 0) {
      for (int i = tid; i < ((TC_ROWS / 4) << lper); i += a8tc::TC_WARPS * 32) {
        const int j = i / (TC_ROWS / 4), r = (i % (TC_ROWS / 4)) * 4;
        const int n = n0 + r, b = b0 + j;
        const bool ok = n < N && b < nb;
        a8tc::cp_async16(sc + j * TC_ROWS + r,
                         ok ? static_cast<const void*>(scales + (size_t)b * N + n) : scales, ok);
      }
    } else {
      for (int i = tid; i < (TC_ROWS << lper); i += a8tc::TC_WARPS * 32) {
        const int j = i / TC_ROWS, r = i % TC_ROWS;
        const int n = n0 + r, b = b0 + j;
        const bool ok = n < N && b < nb;
        a8tc::cp_async4(sc + j * TC_ROWS + r,
                        ok ? static_cast<const void*>(scales + (size_t)b * N + n) : scales, ok);
      }
    }
  }

  static __device__ __forceinline__ float scale(const float* sc, int row, int j) {
    return sc[j * a8tc::TC_ROWS + row];
  }
};

static_assert(a8tc::TC_ROWS * (a8tc::KC / 32) * 4 == a8tc::SC_STAGE,
              "a chunk of 32-code blocks fills the scale stage");

}  // namespace

// The launch plan of a shape: the chunks per K split and the scratch a
// launch with it needs, f32 partial sums and int counts that are 0 (the
// kernel leaves them 0), both 0 when K is not split. bs a power of two in
// [32, 1024].
extern "C" void tbnb_int4_plan(int M, int N, int Kp, int bs, int* cps, long long* part_floats,
                               int* counts) {
  a8tc::plan<Int4>(M, N, Kp, bs, cps, part_floats, counts);
}

// x int8 [M, Kp], w uint8 [N, Kp/2], scales f32 [Kp/bs, N], sx f32 [M],
// out f32 [M, N], all contiguous, x and w 16-byte aligned; cps, part and
// count as tbnb_int4_plan gives them for this shape (part and count must not
// be in use by a launch on another stream). Kp % bs == 0; bs a power of two
// in [32, 1024]. Returns cudaGetLastError() after the launch.
extern "C" int tbnb_int4_matmul(const void* x, const void* w, const void* scales,
                                const void* sx, void* out, void* part, void* count, int M,
                                int N, int Kp, int bs, int cps, void* stream) {
  return a8tc::launch<Int4>(static_cast<const int8_t*>(x), static_cast<const uint8_t*>(w),
                            static_cast<const float*>(scales), static_cast<const float*>(sx),
                            static_cast<float*>(out), static_cast<float*>(part),
                            static_cast<int*>(count), M, N, Kp, bs, cps, NoArg{},
                            static_cast<cudaStream_t>(stream));
}
