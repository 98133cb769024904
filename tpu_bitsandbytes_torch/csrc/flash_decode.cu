// K2: single-token GQA attention over the int8 KV cache, for Hopper (sm_90a).
//
// Takes the place of tpu_bitsandbytes/ops/flash_decode.py:_kernel
// (pallas_call at :188), one launch per layer, and computes what the JAX
// package's default decode attention computes
// (models/layers.py:gqa_attention_kv_quant, staged=), for one (slot b, kv
// head) serving its REP query heads:
//   * logit = dot_f32(q, k) * (k_scale * scale / 127): q as given (an int8
//     code is exact in every float type), products exact, f32 sums; optional
//     softcap; the main block keeps kpos <= off - step - 1 (and the window),
//     the staged block keeps j <= step; masked logits are -1e30, so a row
//     with every entry masked gives uniform p, never NaN;
//   * one max m and one denominator l over both blocks, p = exp(logit - m);
//   * pv = p * (v_scale / 127), rounded to q's dtype when q is bf16 or f16
//     (the default chain's PV operand), kept in f32 for f32 q;
//   * out = dot_f32(pv, v) / l over both blocks. An unstaged call (step =
//     -1, a fully masked staged block) divides p by l before pv is rounded
//     and not after, as the chain's unstaged branch (a softmax) does.
// The JAX package's Pallas kernel quantizes p to int8 against its row max
// instead; at a few thousand keys the many small probabilities round to
// codes 0-2 and their mass leaves the PV sum, so this kernel keeps p in
// float as the default chain does.
//
// Bound on the H100: the bytes of the keys the masks keep, 2*H_kv*(D+4) per
// kept key (codes plus f32 scales of K and V; chip_smoke.k2_bound_ms), against
// ~4*H*D float operations per key on the CUDA cores: bandwidth-bound. The
// engine passes the span of its longest slot, so a short slot's span is
// mostly masked keys.
//
// Design. Each block derives from off[b], step, window and kpos_start the
// interval of main keys the masks keep and reads K, V and scales only there,
// plus the C staged keys: a masked key's p is exp(-1e30 - m) = 0, which adds
// nothing to l or to the PV sums. The one exception is a slot whose every key
// is masked (main and staged): there m = -1e30 and p = 1 over all T + C keys,
// so the interval is the whole span. The slot's kept keys and its staged
// block, in that order, are split evenly over a cluster of S CTAs (S <= 8,
// chosen on the host from the shape and the card by tbnb_flash_decode_plan,
// never from off, so one CUDA graph serves every step). The max m and the
// denominator l are exchanged through distributed shared memory between
// cluster.sync()s. Every sum runs in a fixed order (shuffle trees, warps in
// order, ranks in order), so the same inputs give the same bits on every
// launch. A CTA's time is a chain of dependent steps (load, reduce,
// cluster.sync), so each loop keeps U = 4 key rows per thread in flight.
// QK: D/16 lanes per key row, 16-byte loads of codes, q rows in shared memory
// as f32, partials reduced with shuffles. Softmax passes: all eight warps,
// 8/REP per head, partials combined in warp order. PV: a thread owns 16
// contiguous columns of one V row (16-byte loads) and keeps REP x 16 f32
// sums, reduced with shuffles, then over the warps in order, then over the
// ranks in order. An int8 code becomes a float by its bits (0x4B0000xx is
// 2^23 + xx), two full-rate instructions. Shared memory per CTA holds the
// logits of its share, REP x ceil((T + C) / S) floats, and the warps' PV
// partials, 8 x REP x D floats.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int U = 4;            // key rows a thread has in flight in the QK and PV loops
constexpr int RED = NWARPS;     // softmax partials per quantity: [REP][WPH], REP * WPH <= 8
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
constexpr size_t SMEM_LIMIT = 232448;  // dynamic shared memory one CTA may use
constexpr int NSTAT = 2;        // per head, read by the cluster: local max, local l

struct Strides {
  long long b, h, t;
};

struct Params {
  const void* q;
  long long q_sb, q_sh;  // q strides in elements; the last axis is contiguous
  int q_dtype;           // 0 f32, 1 bf16, 2 f16
  const int8_t *kq, *vq, *stk, *stv;
  const float *ks, *vs, *stks, *stvs;
  const int* off;
  float* out;
  int Hkv, T, C, D, S, per;  // per: logits one CTA holds per head
  Strides kv, sc, skv, ssc;
  int step, kpos_start, window;
  float softcap, lg_c;  // lg_c = scale / 127
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

// the 16 int8 codes of v as floats, exactly: (w ^ 0x80808080) holds code + 128
// per byte; 0x4B0000xx is the float 2^23 + xx
__device__ __forceinline__ void codes16(const int4 v, float (&f)[16]) {
  const unsigned w[4] = {(unsigned)v.x ^ 0x80808080u, (unsigned)v.y ^ 0x80808080u,
                         (unsigned)v.z ^ 0x80808080u, (unsigned)v.w ^ 0x80808080u};
#pragma unroll
  for (int k = 0; k < 16; ++k)
    f[k] = __int_as_float((int)__byte_perm(w[k >> 2], 0x4B000000u, 0x7440u | (k & 3))) -
           8388736.0f;
}

__device__ __forceinline__ float load_q(const Params& p, long long i) {
  switch (p.q_dtype) {
    case 1: return __bfloat162float(static_cast<const __nv_bfloat16*>(p.q)[i]);
    case 2: return __half2float(static_cast<const __half*>(p.q)[i]);
    default: return static_cast<const float*>(p.q)[i];
  }
}

// pv as the default chain feeds its PV product: in q's dtype
__device__ __forceinline__ float round_pv(float x, int q_dtype) {
  switch (q_dtype) {
    case 1: return __bfloat162float(__float2bfloat16_rn(x));
    case 2: return __half2float(__float2half_rn(x));
    default: return x;
  }
}

__host__ __device__ constexpr size_t pad16(size_t n) { return (n + 15) & ~(size_t)15; }

template <int REP>
__device__ __forceinline__ void add_pv(float (&a)[REP][16], const int4 v, const float* pv,
                                       int per, int li) {
  float f[16];
  codes16(v, f);
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const float c = pv[r * per + li];
#pragma unroll
    for (int k = 0; k < 16; ++k) a[r][k] = fmaf(c, f[k], a[r][k]);
  }
}

// grid (S, H_kv, B), clusters of (S, 1, 1): the cluster of (b, kv head)
// REP <= 2: registers capped so that 5 CTAs fit an SM (660 on an H100: the
// 640 CTAs of a 13B-shaped step at S = 2 run in one wave)
template <int REP>
__global__ void __launch_bounds__(THREADS, REP <= 2 ? 5 : 1) flash_decode_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int S = p.S, D = p.D, T = p.T, C = p.C, PER = p.per;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = p.Hkv * REP;

  float* lg = reinterpret_cast<float*>(smem);  // [REP][PER]: logits, then pv
  size_t o = pad16((size_t)REP * PER * 4);
  float* qf = reinterpret_cast<float*>(smem + o);  // [REP][D]
  o += (size_t)REP * D * 4;
  float* part = reinterpret_cast<float*>(smem + o);  // [NWARPS][REP][D]; [0] read by the cluster
  o += (size_t)NWARPS * REP * D * 4;
  float* st = reinterpret_cast<float*>(smem + o);  // [REP][NSTAT], read by the cluster
  float* gl = st + REP * NSTAT;                    // [REP]: the cluster's l
  float* red = gl + REP;                           // [2][RED]: softmax partials
  constexpr int WPH = REP >= NWARPS ? 1 : NWARPS / REP;  // warps per head

  // the main keys the masks keep: t in [t_lo, t_hi); the staged ones j in [j_lo, j_hi)
  const int off_b = p.off[b];
  int t_hi = min(T, max(0, off_b - p.step - p.kpos_start));
  int t_lo = p.window > 0 ? min(T, max(0, off_b - p.window + 1 - p.kpos_start)) : 0;
  const int j_lo = p.window > 0 ? max(0, p.step - p.window + 1) : 0;
  const int j_hi = min(C, p.step + 1);
  if (t_hi <= t_lo && j_hi <= j_lo) {  // every key masked: p = 1 over the whole span
    t_lo = 0;
    t_hi = T;
  }
  t_hi = max(t_hi, t_lo);
  const int nmain = t_hi - t_lo;
  // this CTA's share [i0, i1) of the slot's keys: kept main keys, then staged
  const int n = nmain + C;
  const int share = (n + S - 1) / S;
  const int i0 = min(n, rank * share);
  const int cnt = min(n, i0 + share) - i0;
  const int m_end = min(cnt, max(0, nmain - i0));  // local indices below are main keys

  const int8_t* kbase = p.kq + b * p.kv.b + hk * p.kv.h + t_lo * p.kv.t;
  const int8_t* vbase = p.vq + b * p.kv.b + hk * p.kv.h + t_lo * p.kv.t;
  const float* ksb = p.ks + b * p.sc.b + hk * p.sc.h + t_lo * p.sc.t;
  const float* vsb = p.vs + b * p.sc.b + hk * p.sc.h + t_lo * p.sc.t;
  const int8_t* skbase = p.stk + b * p.skv.b + hk * p.skv.h;
  const int8_t* svbase = p.stv + b * p.skv.b + hk * p.skv.h;
  const float* sksb = p.stks + b * p.ssc.b + hk * p.ssc.h;
  const float* svsb = p.stvs + b * p.ssc.b + hk * p.ssc.h;

  // 1. the REP query rows as f32
  for (int i = tid; i < REP * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    qf[i] = load_q(p, b * p.q_sb + (hk * REP + r) * p.q_sh + d);
  }
  __syncthreads();

  // 2. logits of the share: D/16 lanes per key row, 16-byte loads, U rows
  //    per thread in flight
  {
    const int lpt = D >> 4;
    const int sub = tid % lpt;
    const int per_pass = THREADS / lpt;
    for (int base = 0; base < cnt; base += U * per_pass) {  // uniform trip count
      int4 k16[U];
      float ksc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int li = base + u * per_pass + tid / lpt;
        const int i = i0 + li;
        k16[u] = make_int4(0, 0, 0, 0);
        ksc[u] = 0.f;
        if (li < m_end) {
          k16[u] = *reinterpret_cast<const int4*>(kbase + (long long)i * p.kv.t + sub * 16);
          if (sub == 0) ksc[u] = ksb[(long long)i * p.sc.t];
        } else if (li < cnt) {
          const int j = i - nmain;
          k16[u] = *reinterpret_cast<const int4*>(skbase + (long long)j * p.skv.t + sub * 16);
          if (sub == 0) ksc[u] = sksb[(long long)j * p.ssc.t];
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int li = base + u * per_pass + tid / lpt;
        float kf[16];
        codes16(k16[u], kf);
        float dots[REP];
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          const float4* q4 = reinterpret_cast<const float4*>(qf + r * D + sub * 16);
          float d = 0.f;
#pragma unroll
          for (int k4 = 0; k4 < 4; ++k4) {
            const float4 qv = q4[k4];
            d = fmaf(qv.x, kf[4 * k4], d);
            d = fmaf(qv.y, kf[4 * k4 + 1], d);
            d = fmaf(qv.z, kf[4 * k4 + 2], d);
            d = fmaf(qv.w, kf[4 * k4 + 3], d);
          }
          for (int o2 = lpt >> 1; o2 >= 1; o2 >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o2);
          dots[r] = d;
        }
        if (li < cnt && sub == 0) {
          const int i = i0 + li;
          bool keep;
          if (li < m_end) {
            const int kpos = p.kpos_start + t_lo + i;
            keep = kpos <= off_b - p.step - 1;
            if (p.window > 0) keep = keep && kpos > off_b - p.window;
          } else {
            const int j = i - nmain;
            keep = j <= p.step;
            if (p.window > 0) keep = keep && j > p.step - p.window;
          }
          const float kscale = ksc[u] * p.lg_c;
#pragma unroll
          for (int r = 0; r < REP; ++r) {
            float x = dots[r] * kscale;
            if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
            lg[r * PER + li] = keep ? x : -1e30f;
          }
        }
      }
    }
  }
  __syncthreads();

  // Softmax passes: WPH warps per head, each over every WPH-th 32 keys of
  // the share; their partials meet in `red` and are combined in warp order.
  const int head = warp / WPH, seg = warp % WPH;

  // 3. the share's max per head, then the cluster's
  if (head < REP) {
    float mx = -INFINITY;
    for (int li = seg * 32 + lane; li < cnt; li += WPH * 32) mx = fmaxf(mx, lg[head * PER + li]);
    mx = warp_max(mx);
    if (lane == 0) red[head * WPH + seg] = mx;
  }
  __syncthreads();
  if (tid < REP) {
    float mx = -INFINITY;
    for (int w = 0; w < WPH; ++w) mx = fmaxf(mx, red[tid * WPH + w]);
    st[tid * NSTAT + 0] = mx;
  }
  cluster.sync();

  // 4. p and its sum over the share
  if (head < REP) {
    const float m = warp_max(lane < S ? cluster.map_shared_rank(st, lane)[head * NSTAT + 0]
                                      : -INFINITY);
    float l = 0.f;
    for (int li = seg * 32 + lane; li < cnt; li += WPH * 32) {
      const float pr = expf(lg[head * PER + li] - m);
      l += pr;
      lg[head * PER + li] = pr;
    }
    l = warp_sum(l);
    if (lane == 0) red[RED + head * WPH + seg] = l;
  }
  __syncthreads();
  if (tid < REP) {
    float l = 0.f;
    for (int w = 0; w < WPH; ++w) l += red[RED + tid * WPH + w];
    st[tid * NSTAT + 1] = l;
  }
  cluster.sync();

  // 5. the cluster's l, the ranks' sums in rank order; pv = p * v_scale /
  //    127 rounded to q's dtype, p divided by l first in an unstaged call
  //    (step < 0), as the chain's unstaged softmax normalizes before its
  //    PV operand is rounded
  const bool norm = p.step < 0;
  if (tid < REP) {
    float l = 0.f;
    for (int q = 0; q < S; ++q) l += cluster.map_shared_rank(st, q)[tid * NSTAT + 1];
    gl[tid] = l;
  }
  __syncthreads();
  for (int idx = tid; idx < REP * cnt; idx += THREADS) {
    const int r = idx / cnt, li = idx - r * cnt;
    const float vsc = li < m_end ? vsb[(long long)(i0 + li) * p.sc.t]
                                 : svsb[(long long)(i0 + li - nmain) * p.ssc.t];
    const float pr = norm ? lg[r * PER + li] / gl[r] : lg[r * PER + li];
    lg[r * PER + li] = round_pv(pr * __fdiv_rn(vsc, 127.0f), p.q_dtype);
  }
  __syncthreads();

  // 6. PV: a thread owns 16 columns of one V row, U rows in flight; main
  //    keys, then staged; its sums reduced over the warp's rows by shuffles,
  //    then over the warps in order
  {
    const int cpr = D >> 4;  // threads per row
    const int c16 = tid % cpr;
    const int rows = THREADS / cpr;
    float a[REP][16];
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int k = 0; k < 16; ++k) a[r][k] = 0.f;
    for (int li = tid / cpr; li < m_end; li += U * rows) {
      int4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        v[u] = li + u * rows < m_end
                   ? *reinterpret_cast<const int4*>(vbase + (long long)(i0 + li + u * rows) * p.kv.t +
                                                    c16 * 16)
                   : make_int4(0, 0, 0, 0);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (li + u * rows < m_end) add_pv<REP>(a, v[u], lg, PER, li + u * rows);
    }
    for (int li = m_end + tid / cpr; li < cnt; li += rows)
      add_pv<REP>(a,
                  *reinterpret_cast<const int4*>(svbase + (long long)(i0 + li - nmain) * p.skv.t +
                                                 c16 * 16),
                  lg, PER, li);
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        float v = a[r][k];
        for (int o2 = cpr; o2 < 32; o2 <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o2);
        if (lane < cpr) part[(warp * REP + r) * D + c16 * 16 + k] = v;
      }
  }
  __syncthreads();
  for (int idx = tid; idx < REP * D; idx += THREADS) {
    float s = part[idx];
    for (int w = 1; w < NWARPS; ++w) s += part[w * REP * D + idx];
    part[idx] = s;
  }
  cluster.sync();

  // 7. epilogue, spread over the ranks: the S partial sums in rank order,
  //    then / l where p was not normalized
  for (int idx = rank * THREADS + tid; idx < REP * D; idx += S * THREADS) {
    const int r = idx / D, d = idx - r * D;
    float s = 0.f;
    for (int q = 0; q < S; ++q) s += cluster.map_shared_rank(part, q)[idx];
    p.out[((size_t)b * H + hk * REP + r) * D + d] = norm ? s : s / gl[r];
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

size_t smem_bytes(int rep, int T, int C, int D, int S) {
  const size_t per = ((size_t)T + C + S - 1) / S;
  return pad16((size_t)rep * per * 4) + (size_t)rep * D * 4 + (size_t)NWARPS * rep * D * 4 +
         (size_t)rep * (NSTAT + 1) * 4 + (size_t)2 * RED * 4;
}

template <int REP>
int set_smem_attr(size_t smem) {
  static size_t attr = 0;  // the dynamic shared memory allowed so far
  if (smem > attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_kernel<REP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr = smem;
  }
  return 0;
}

template <int REP>
int launch(const Params& p, int B, size_t smem, cudaStream_t st) {
  const int e0 = set_smem_attr<REP>(smem);
  if (e0 != 0) return e0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.S, p.Hkv, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, flash_decode_kernel<REP>, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

// CTAs per cluster for a shape. A CTA's time is a fixed chain of steps plus
// its share of keys, so splitting pays only while all B * Hkv clusters run
// at once: the largest S up to one per 256 keys of the span (at most 8)
// whose clusters fit on the card together, else the least S whose share
// fits in shared memory.
template <int REP>
int plan(int T, int C, int D, int B, int Hkv) {
  const int s_max = std::min(MAX_CLUSTER, std::max(1, (T + 255) / 256));
  int s_min = 1;
  while (s_min < MAX_CLUSTER && smem_bytes(REP, T, C, D, s_min) > SMEM_LIMIT) ++s_min;
  for (int s = s_max; s > s_min; --s) {
    const size_t smem = smem_bytes(REP, T, C, D, s);
    int per_sm = 0;
    if (set_smem_attr<REP>(smem) == 0)
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flash_decode_kernel<REP>, THREADS,
                                                    smem);
    if ((long long)per_sm * sm_count() >= (long long)B * Hkv * s) return s;
  }
  return s_min;
}

}  // namespace

// Dynamic shared memory of one CTA of a cluster of S over T + C keys.
extern "C" long long tbnb_flash_decode_smem(int rep, int T, int C, int D, int S) {
  return (long long)smem_bytes(rep, T, C, D, S);
}

// The CTAs per cluster (1..8) the kernel takes for this shape: a function
// of the shape and the card alone, never of the data.
extern "C" int tbnb_flash_decode_plan(int rep, int T, int C, int D, int B, int Hkv) {
  switch (rep) {
    case 1: return plan<1>(T, C, D, B, Hkv);
    case 2: return plan<2>(T, C, D, B, Hkv);
    case 3: return plan<3>(T, C, D, B, Hkv);
    case 4: return plan<4>(T, C, D, B, Hkv);
    case 5: return plan<5>(T, C, D, B, Hkv);
    case 6: return plan<6>(T, C, D, B, Hkv);
    case 7: return plan<7>(T, C, D, B, Hkv);
    case 8: return plan<8>(T, C, D, B, Hkv);
    default: return 1;
  }
}

// q [B, H, D] f32, bf16 or f16 (q_dtype 0/1/2) read through strides (in
// elements; the last axis contiguous); k/v codes int8 [B, Hkv, T, D] and
// scales f32 [B, Hkv, T] read through strides likewise (codes 16-byte
// aligned rows); staged block likewise with C keys; off int32 [B]; out f32
// [B, H, D]. window <= 0 and softcap <= 0 disable those options. rep in
// 1..8; D a power of two in [16, 512]; S in 1..8, the CTAs of a cluster.
// Returns the launch's error code, else cudaGetLastError().
extern "C" int tbnb_flash_decode(
    const void* q, long long q_sb, long long q_sh, int q_dtype, const void* kq,
    const void* ks, const void* vq, const void* vs, const void* stk, const void* stks,
    const void* stv, const void* stvs, const void* off, void* out, int B, int Hkv, int rep,
    int T, int C, int D, int S, long long kv_sb, long long kv_sh, long long kv_st,
    long long sc_sb, long long sc_sh, long long sc_st, long long skv_sb, long long skv_sh,
    long long skv_st, long long ssc_sb, long long ssc_sh, long long ssc_st, int step,
    int kpos_start, int window, float softcap, float lg_c, void* stream) {
  if (S < 1 || S > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.q_dtype = q_dtype;
  p.kq = static_cast<const int8_t*>(kq);
  p.vq = static_cast<const int8_t*>(vq);
  p.stk = static_cast<const int8_t*>(stk);
  p.stv = static_cast<const int8_t*>(stv);
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  p.stks = static_cast<const float*>(stks);
  p.stvs = static_cast<const float*>(stvs);
  p.off = static_cast<const int*>(off);
  p.out = static_cast<float*>(out);
  p.Hkv = Hkv;
  p.T = T;
  p.C = C;
  p.D = D;
  p.S = S;
  p.per = (T + C + S - 1) / S;
  p.kv = Strides{kv_sb, kv_sh, kv_st};
  p.sc = Strides{sc_sb, sc_sh, sc_st};
  p.skv = Strides{skv_sb, skv_sh, skv_st};
  p.ssc = Strides{ssc_sb, ssc_sh, ssc_st};
  p.step = step;
  p.kpos_start = kpos_start;
  p.window = window;
  p.softcap = softcap;
  p.lg_c = lg_c;
  const size_t smem = smem_bytes(rep, T, C, D, S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rep) {
    case 1: return launch<1>(p, B, smem, st);
    case 2: return launch<2>(p, B, smem, st);
    case 3: return launch<3>(p, B, smem, st);
    case 4: return launch<4>(p, B, smem, st);
    case 5: return launch<5>(p, B, smem, st);
    case 6: return launch<6>(p, B, smem, st);
    case 7: return launch<7>(p, B, smem, st);
    case 8: return launch<8>(p, B, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
