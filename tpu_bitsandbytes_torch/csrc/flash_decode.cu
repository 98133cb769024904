// K2: single-token GQA attention over the int8 KV cache, for Hopper (sm_90a).
//
// Replaces tpu_bitsandbytes/ops/flash_decode.py:_kernel (pallas_call at
// :188) and computes exactly what it does, for one (slot b, kv head) per
// thread block serving its REP query heads:
//   * q rows are quantized to int8: q_s = max|q| + 1e-9,
//     q_i8 = round(q * (127 / q_s));
//   * logit = dot_i32(q_i8, k) * (q_s * scale / 127^2) * k_scale, optional
//     softcap; the main block keeps kpos <= off - step - 1 (and the window),
//     the staged block keeps j <= step; masked logits are -1e30, so a row
//     with every entry masked gives uniform p, never NaN;
//   * one max and one denominator over both blocks; pv = p * v_scale is
//     quantized per block to [0, 127] with s_p = max(pv) + 1e-30;
//   * out = (dot_i32(pv_i8, v) * s_p + dot_i32(pvs_i8, st_v) * s_ps)
//           / (l * 127^2).
// Rounding is rintf (half to even, like jnp.round); exp is expf.
//
// Bound on the H100: the KV bytes, 2*B*H_kv*(T+C)*(D+4) (codes plus f32
// scales), against ~4*B*H*(T+C)*D int8 operations: bandwidth-bound.
//
// Design: the logits of all T+C keys of the block's REP heads live in
// dynamic shared memory (the wrapper raises when they do not fit 227 KB).
// QK: groups of D/16 lanes each read one key row as 16-byte loads and
// reduce their __dp4a partials with shuffles. PV: each thread owns 4
// columns of D for a strided subset of keys and accumulates int32 sums,
// merged exactly with shared-memory atomics. The kernel reads the cache
// through its strides, so the engine's span view is never copied. One block
// per (b, kv head) keeps the KV reads of a head in one SM; splitting T
// across blocks comes later.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;

struct Strides {
  long long b, h, t;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide reductions; every thread gets the result. `red` holds NWARPS+1
// floats of shared scratch.
__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float r = lane < NWARPS ? red[lane] : -INFINITY;
    r = warp_max(r);
    if (lane == 0) red[NWARPS] = r;
  }
  __syncthreads();
  const float out = red[NWARPS];
  __syncthreads();
  return out;
}

__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float r = lane < NWARPS ? red[lane] : 0.f;
    r = warp_sum(r);
    if (lane == 0) red[NWARPS] = r;
  }
  __syncthreads();
  const float out = red[NWARPS];
  __syncthreads();
  return out;
}

__device__ __forceinline__ int dot16(const int4 a, const int4 b) {
  int d = __dp4a(a.x, b.x, 0);
  d = __dp4a(a.y, b.y, d);
  d = __dp4a(a.z, b.z, d);
  return __dp4a(a.w, b.w, d);
}

template <int REP>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const float* __restrict__ q, const int8_t* __restrict__ kq,
                    const float* __restrict__ ks, const int8_t* __restrict__ vq,
                    const float* __restrict__ vs, const int8_t* __restrict__ stk,
                    const float* __restrict__ stks, const int8_t* __restrict__ stv,
                    const float* __restrict__ stvs, const int* __restrict__ off,
                    float* __restrict__ out, int Hkv, int T, int C, int D,
                    Strides kv, Strides sc, Strides skv, Strides ssc, int step,
                    int kpos_start, int window, float softcap, float lg_c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int TC = T + C;
  float* lg = reinterpret_cast<float*>(smem);                  // [REP][TC]
  int* code = reinterpret_cast<int*>(smem);                    // same buffer, later
  const size_t lg_bytes = ((size_t)REP * TC * 4 + 15) & ~(size_t)15;
  int8_t* qi8 = reinterpret_cast<int8_t*>(smem + lg_bytes);    // [REP][D]
  int* acc = reinterpret_cast<int*>(smem + lg_bytes + (((size_t)REP * D + 15) & ~(size_t)15));
  float* stat = reinterpret_cast<float*>(acc + 2 * REP * D);   // [REP][5]
  float* red = stat + REP * 5;                                  // [NWARPS+1]

  const int b = blockIdx.x, hk = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = Hkv * REP;
  const int off_b = off[b];

  const int8_t* kbase = kq + b * kv.b + hk * kv.h;
  const int8_t* vbase = vq + b * kv.b + hk * kv.h;
  const float* ksb = ks + b * sc.b + hk * sc.h;
  const float* vsb = vs + b * sc.b + hk * sc.h;
  const int8_t* skbase = stk + b * skv.b + hk * skv.h;
  const int8_t* svbase = stv + b * skv.b + hk * skv.h;
  const float* sksb = stks + b * ssc.b + hk * ssc.h;
  const float* svsb = stvs + b * ssc.b + hk * ssc.h;

  // 1. quantize the REP query rows (one warp per row); zero the PV sums
  for (int i = tid; i < 2 * REP * D; i += THREADS) acc[i] = 0;
  if (warp < REP) {
    const float* qr = q + ((size_t)b * H + hk * REP + warp) * D;
    float mx = 0.f;
    for (int d = lane; d < D; d += 32) mx = fmaxf(mx, fabsf(qr[d]));
    mx = warp_max(mx);
    const float q_s = mx + 1e-9f;
    const float inv = 127.0f / q_s;
    for (int d = lane; d < D; d += 32)
      qi8[warp * D + d] = (int8_t)fminf(fmaxf(rintf(qr[d] * inv), -127.f), 127.f);
    if (lane == 0) stat[warp * 5 + 0] = q_s * lg_c;
  }
  __syncthreads();

  // 2. logits: D/16 lanes per key row, 16-byte loads, shuffle-reduced dots
  {
    const int lpt = D >> 4;
    const int sub = tid % lpt;
    const int per_pass = THREADS / lpt;
    for (int base = 0; base < TC; base += per_pass) {  // uniform trip count
      const int t = base + tid / lpt;
      const bool valid = t < TC;
      const bool in_main = t < T;
      int4 kv16 = make_int4(0, 0, 0, 0);
      if (valid) {
        const int8_t* row = in_main ? kbase + t * kv.t : skbase + (t - T) * skv.t;
        kv16 = *reinterpret_cast<const int4*>(row + sub * 16);
      }
      int dots[REP];
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        int d = dot16(kv16, *reinterpret_cast<const int4*>(qi8 + r * D + sub * 16));
        for (int o = lpt >> 1; o >= 1; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        dots[r] = d;
      }
      if (valid && sub == 0) {
        bool keep;
        float kscale;
        if (in_main) {
          const int kpos = kpos_start + t;
          keep = kpos <= off_b - step - 1;
          if (window > 0) keep = keep && kpos > off_b - window;
          kscale = ksb[t * sc.t];
        } else {
          const int j = t - T;
          keep = j <= step;
          if (window > 0) keep = keep && j > step - window;
          kscale = sksb[j * ssc.t];
        }
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          float x = (float)dots[r] * stat[r * 5 + 0] * kscale;
          if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
          lg[r * TC + t] = keep ? x : -1e30f;
        }
      }
    }
  }
  __syncthreads();

  // 3. shared softmax over both blocks, then pv = p * v_scale quantized
  //    to [0, 127] per block
  for (int r = 0; r < REP; ++r) {
    float* row = lg + r * TC;
    float mx = -INFINITY;
    for (int t = tid; t < TC; t += THREADS) mx = fmaxf(mx, row[t]);
    mx = block_max(mx, red);
    float lm = 0.f, ls = 0.f, pm = 0.f, ps = 0.f;
    for (int t = tid; t < TC; t += THREADS) {
      const float p = expf(row[t] - mx);
      if (t < T) {
        lm += p;
        const float pv = p * vsb[t * sc.t];
        row[t] = pv;
        pm = fmaxf(pm, pv);
      } else {
        ls += p;
        const float pv = p * svsb[(t - T) * ssc.t];
        row[t] = pv;
        ps = fmaxf(ps, pv);
      }
    }
    lm = block_sum(lm, red);
    ls = block_sum(ls, red);
    pm = block_max(pm, red);
    ps = block_max(ps, red);
    const float s_p = pm + 1e-30f, s_ps = ps + 1e-30f;
    const float inv_p = 127.0f / s_p, inv_ps = 127.0f / s_ps;
    for (int t = tid; t < TC; t += THREADS) {
      const float c = rintf(row[t] * (t < T ? inv_p : inv_ps));
      code[r * TC + t] = (int)fminf(fmaxf(c, 0.f), 127.f);
    }
    if (tid == 0) {
      stat[r * 5 + 1] = lm + ls;
      stat[r * 5 + 2] = s_p;
      stat[r * 5 + 3] = s_ps;
    }
  }
  __syncthreads();

  // 4. PV: each thread owns 4 columns of D over a strided subset of keys
  {
    const int nchunk = D >> 2;
    const int c4 = tid % nchunk;
    const int groups = THREADS / nchunk;
    int am[REP][4], as[REP][4];
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) am[r][i] = as[r][i] = 0;
    for (int t = tid / nchunk; t < TC; t += groups) {
      const bool in_main = t < T;
      const int8_t* row = in_main ? vbase + t * kv.t : svbase + (t - T) * skv.t;
      const char4 v4 = *reinterpret_cast<const char4*>(row + c4 * 4);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const int p = code[r * TC + t];
        if (in_main) {
          am[r][0] += p * v4.x; am[r][1] += p * v4.y;
          am[r][2] += p * v4.z; am[r][3] += p * v4.w;
        } else {
          as[r][0] += p * v4.x; as[r][1] += p * v4.y;
          as[r][2] += p * v4.z; as[r][3] += p * v4.w;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        atomicAdd(&acc[r * D + c4 * 4 + i], am[r][i]);
        atomicAdd(&acc[(REP + r) * D + c4 * 4 + i], as[r][i]);
      }
  }
  __syncthreads();

  // 5. epilogue: /127 for the p codes, /127 for the v codes
  for (int i = tid; i < REP * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const float o = (float)acc[r * D + d] * stat[r * 5 + 2]
                  + (float)acc[(REP + r) * D + d] * stat[r * 5 + 3];
    out[((size_t)b * H + hk * REP + r) * D + d] = o / (stat[r * 5 + 1] * 16129.0f);
  }
}

template <int REP>
int launch(dim3 grid, size_t smem, cudaStream_t st, const float* q, const int8_t* kq,
           const float* ks, const int8_t* vq, const float* vs, const int8_t* stk,
           const float* stks, const int8_t* stv, const float* stvs, const int* off,
           float* out, int Hkv, int T, int C, int D, Strides kv, Strides sc,
           Strides skv, Strides ssc, int step, int kpos_start, int window,
           float softcap, float lg_c) {
  cudaError_t e = cudaFuncSetAttribute(flash_decode_kernel<REP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  flash_decode_kernel<REP><<<grid, THREADS, smem, st>>>(
      q, kq, ks, vq, vs, stk, stks, stv, stvs, off, out, Hkv, T, C, D, kv, sc,
      skv, ssc, step, kpos_start, window, softcap, lg_c);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory the kernel needs for one (b, kv head) block.
extern "C" long long tbnb_flash_decode_smem(int rep, int T, int C, int D) {
  const size_t lg = (((size_t)rep * (T + C) * 4) + 15) & ~(size_t)15;
  const size_t qb = (((size_t)rep * D) + 15) & ~(size_t)15;
  return (long long)(lg + qb + (size_t)2 * rep * D * 4 + ((size_t)rep * 5 + NWARPS + 1) * 4);
}

// q f32 [B, H, D] contiguous; k/v codes int8 [B, Hkv, T, D] and scales f32
// [B, Hkv, T] read through strides (in elements; the last axis of the codes
// is contiguous); staged block likewise with C keys; off int32 [B];
// out f32 [B, H, D]. window <= 0 and softcap <= 0 disable those options.
// rep in 1..8; D a power of two in [16, 512]. Returns cudaGetLastError().
extern "C" int tbnb_flash_decode(
    const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
    const void* stk, const void* stks, const void* stv, const void* stvs,
    const void* off, void* out, int B, int Hkv, int rep, int T, int C, int D,
    long long kv_sb, long long kv_sh, long long kv_st,
    long long sc_sb, long long sc_sh, long long sc_st,
    long long skv_sb, long long skv_sh, long long skv_st,
    long long ssc_sb, long long ssc_sh, long long ssc_st,
    int step, int kpos_start, int window, float softcap, float lg_c, void* stream) {
  const dim3 grid(B, Hkv);
  const size_t smem = (size_t)tbnb_flash_decode_smem(rep, T, C, D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides kv{kv_sb, kv_sh, kv_st}, sc{sc_sb, sc_sh, sc_st};
  const Strides skv{skv_sb, skv_sh, skv_st}, ssc{ssc_sb, ssc_sh, ssc_st};
#define TBNB_FD_ARGS                                                                 \
  grid, smem, st, static_cast<const float*>(q), static_cast<const int8_t*>(kq),     \
      static_cast<const float*>(ks), static_cast<const int8_t*>(vq),                \
      static_cast<const float*>(vs), static_cast<const int8_t*>(stk),               \
      static_cast<const float*>(stks), static_cast<const int8_t*>(stv),             \
      static_cast<const float*>(stvs), static_cast<const int*>(off),                \
      static_cast<float*>(out), Hkv, T, C, D, kv, sc, skv, ssc, step, kpos_start,   \
      window, softcap, lg_c
  switch (rep) {
    case 1: return launch<1>(TBNB_FD_ARGS);
    case 2: return launch<2>(TBNB_FD_ARGS);
    case 3: return launch<3>(TBNB_FD_ARGS);
    case 4: return launch<4>(TBNB_FD_ARGS);
    case 5: return launch<5>(TBNB_FD_ARGS);
    case 6: return launch<6>(TBNB_FD_ARGS);
    case 7: return launch<7>(TBNB_FD_ARGS);
    case 8: return launch<8>(TBNB_FD_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TBNB_FD_ARGS
}
