// The int4 runtime cache decoded to bf16: the weight operand of the cache's
// product above K1's rows, for Hopper (sm_90a).
//
// Replaces no TPU kernel: above K1's M the JAX package dequantizes the
// cache to x's dtype and leaves the product to XLA
// (tpu_bitsandbytes/ops/int4cache.py:244-246, a bf16 x bf16 dot with f32
// accumulation). The port runs that product as one bf16 GEMM with an f32
// output on the tensor cores (ops/int4cache.py:int4_matmul); this pass
// writes the GEMM's weight:
//     out[n, k] = bf16_rn(f32(code[n, k]) * scale[k / bs, n])
// with code the two's-complement nibble k of row n (element 2j in the low
// nibble of byte j), scale f32 [Kp/bs, N] and out bf16 [N, Kp]. One f32
// product and one rounding to bf16, as dequant_int4(..., dtype=bfloat16)
// computes it: the two agree bit for bit.
//
// Bound on the H100: bytes. Per weight 0.5 B of codes in and 2 B of bf16
// out (and 4 B of scale per block), against one multiply: 2.5 B per weight
// at 3.35 TB/s. What the design is about is the stores, four fifths of the
// bytes: they have to be whole lines. A warp takes 128 words of codes
// (four bytes, eight codes each) in four steps of 32 consecutive words:
// each step is one 128-byte load and one 512-byte store of bf16, lane t on
// word t of the step. (One thread per 16 bytes of codes, whose four
// 16-byte stores leave each warp's stores 64 bytes apart, ran at 1.6 TB/s
// on the H100 against this design's 2.8; 16-byte loads redistributed by
// shuffles gave 2.75.) All four loads are issued before the first store.
// Each word looks up its own scale (bs a multiple of 8), mostly a hit in L1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int STEPS = 4;  // 32-word steps per warp

// byte j of a row -> bf16 elements 2j (low nibble, low half) and 2j+1
__device__ __forceinline__ uint32_t decode_byte(uint32_t b, float s) {
  const int lo = static_cast<int>((b & 0xFu) ^ 8u) - 8;
  const int hi = static_cast<int>(((b >> 4) & 0xFu) ^ 8u) - 8;
  const __nv_bfloat162 p = __floats2bfloat162_rn(__fmul_rn(static_cast<float>(lo), s),
                                                 __fmul_rn(static_cast<float>(hi), s));
  return *reinterpret_cast<const uint32_t*>(&p);
}

// four packed bytes (eight codes) -> eight bf16 values
__device__ __forceinline__ uint4 decode_word(uint32_t v, float s) {
  return make_uint4(decode_byte(v & 0xFFu, s), decode_byte((v >> 8) & 0xFFu, s),
                    decode_byte((v >> 16) & 0xFFu, s), decode_byte(v >> 24, s));
}

// word w = n * per_row + c holds codes [8 c, 8 c + 8) of row n, whose scale
// is scale[c / per_block, n]
__global__ void __launch_bounds__(WARPS * 32)
    int4_dequant_bf16_kernel(const uint32_t* __restrict__ codes, const float* __restrict__ scales,
                             uint4* __restrict__ out, long long words, int per_row, int N,
                             int per_block) {
  const int lane = threadIdx.x & 31;
  const long long base =
      (static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5)) * (STEPS * 32) + lane;
  uint32_t v[STEPS];
#pragma unroll
  for (int j = 0; j < STEPS; ++j) {
    const long long w = base + j * 32;
    v[j] = w < words ? __ldg(codes + w) : 0u;
  }
#pragma unroll
  for (int j = 0; j < STEPS; ++j) {
    const long long w = base + j * 32;
    if (w < words) {
      const long long n = w / per_row;
      const int c = static_cast<int>(w - n * per_row);
      out[w] = decode_word(v[j], __ldg(scales + static_cast<long long>(c / per_block) * N + n));
    }
  }
}

}  // namespace

// codes uint8 [N, Kp/2], scales f32 [Kp/bs, N], out bf16 [N, Kp], all
// contiguous, codes 4-byte and out 16-byte aligned; bs a multiple of 8 and
// Kp a multiple of bs. Returns cudaGetLastError() after the launch (0 and
// no launch for an empty matrix).
extern "C" int tbnb_int4_dequant_bf16(const void* codes, const void* scales, void* out, int N,
                                      int Kp, int bs, void* stream) {
  const long long words = static_cast<long long>(N) * (Kp / 8);
  if (words == 0) return 0;
  const long long per_cta = WARPS * STEPS * 32;
  int4_dequant_bf16_kernel<<<static_cast<unsigned>((words + per_cta - 1) / per_cta), WARPS * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(codes), static_cast<const float*>(scales),
      static_cast<uint4*>(out), words, Kp / 8, N, bs / 8);
  return static_cast<int>(cudaGetLastError());
}
