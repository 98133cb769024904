// K2: single-token GQA attention over the int8 KV cache, for Hopper (sm_90a).
//
// Replaces tpu_bitsandbytes/ops/flash_decode.py:_kernel (pallas_call at
// :188) and computes exactly what it does, for one (slot b, kv head) serving
// its REP query heads:
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
// Bound on the H100: the bytes of the keys the masks keep, 2*H_kv*(D+4) per
// kept key (codes plus f32 scales of K and V; chip_smoke.k2_bound_ms), against
// ~4*H*D int8 operations per key: bandwidth-bound. The engine passes the span
// of its longest slot, so a short slot's span is mostly masked keys.
//
// Design. Each block derives from off[b], step, window and kpos_start the
// interval of main keys the masks keep and reads K, V and scales only there,
// plus the C staged keys: a masked key's p is exp(-1e30 - m) = 0, which adds
// nothing to l, to the pv maxima or to the PV sums. The one exception is a
// slot whose every key is masked (main and staged): there m = -1e30 and p = 1
// over all T + C keys, so the interval is the whole span. The slot's kept keys
// and its staged block, in that order, are split evenly over a cluster of S
// CTAs (S <= 8, chosen on the host from the shape and the card by
// tbnb_flash_decode_plan, never from off, so one CUDA graph serves every
// step). The three quantities that join the
// shares are exchanged through distributed shared memory between
// cluster.sync()s: the max m (exact in any order), then l and the two pv
// maxima s_p, s_ps (maxima exact; l an f32 sum in another order than the TPU
// kernel's). Each CTA quantizes its own p codes and forms int32 PV sums; the
// outputs are spread over the ranks, each adding the S int32 partials in
// rank order (exact) before the f32 epilogue. One launch per layer, no
// global scratch, no allocation, no synchronization with the host.
// A CTA's time is a chain of dependent steps (load, reduce, cluster.sync),
// so each loop keeps U = 4 key rows per thread in flight. QK: D/16 lanes per
// key row, 16-byte loads, __dp4a partials reduced with shuffles. Softmax
// passes: all eight warps, 8/REP per head, partials combined in warp order.
// PV: a thread owns 16 contiguous columns of one V row (16-byte loads) and
// keeps REP x 16 int32 sums, reduced with shuffles and shared-memory integer
// adds (exact, so their order does not matter). Shared memory per CTA holds
// the logits of its share only: REP x ceil((T + C) / S) floats.

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
constexpr int NSTAT = 6;        // per head: q scale, local max, l main, l staged, pv maxima
constexpr int NGLOB = 5;        // per head: l, s_p, s_ps, 127/s_p, 127/s_ps

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
  float softcap, lg_c;
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

__device__ __forceinline__ int dot16(const int4 a, const int4 b) {
  int d = __dp4a(a.x, b.x, 0);
  d = __dp4a(a.y, b.y, d);
  d = __dp4a(a.z, b.z, d);
  return __dp4a(a.w, b.w, d);
}

__device__ __forceinline__ float load_q(const Params& p, long long i) {
  switch (p.q_dtype) {
    case 1: return __bfloat162float(static_cast<const __nv_bfloat16*>(p.q)[i]);
    case 2: return __half2float(static_cast<const __half*>(p.q)[i]);
    default: return static_cast<const float*>(p.q)[i];
  }
}

__host__ __device__ constexpr size_t pad16(size_t n) { return (n + 15) & ~(size_t)15; }

// acc[r][c16*16 ..] += the REP x 16 sums of every thread that owns column
// group c16: shuffles inside the warp, then shared-memory integer adds.
template <int REP>
__device__ __forceinline__ void flush_pv(int (&a)[REP][16], int* acc, int D, int c16, int cpr) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      int v = a[r][k];
      for (int o = cpr; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane < cpr) atomicAdd(&acc[r * D + c16 * 16 + k], v);
      a[r][k] = 0;
    }
}

template <int REP>
__device__ __forceinline__ void add_pv(int (&a)[REP][16], const int4 v, const int* code, int per,
                                       int li) {
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const int c = code[r * per + li];
#pragma unroll
    for (int k = 0; k < 16; ++k)
      a[r][k] += c * static_cast<int>(static_cast<int8_t>(w[k >> 2] >> (8 * (k & 3))));
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
  int* code = reinterpret_cast<int*>(smem);    // the same buffer: p codes
  size_t o = pad16((size_t)REP * PER * 4);
  int8_t* qi8 = reinterpret_cast<int8_t*>(smem + o);  // [REP][D]
  o += pad16((size_t)REP * D);
  int* acc = reinterpret_cast<int*>(smem + o);  // [2][REP][D]: main, staged
  o += (size_t)2 * REP * D * 4;
  float* st = reinterpret_cast<float*>(smem + o);  // [REP][NSTAT], read by the cluster
  float* gs = st + REP * NSTAT;                    // [REP][NGLOB]
  float* red = gs + REP * NGLOB;                   // [4][RED]: softmax partials
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

  // 1. quantize the REP query rows (one warp per row); zero the PV sums
  for (int i = tid; i < 2 * REP * D; i += THREADS) acc[i] = 0;
  if (warp < REP) {
    const long long qrow = b * p.q_sb + (hk * REP + warp) * p.q_sh;
    float mx = 0.f;
    for (int d = lane; d < D; d += 32) mx = fmaxf(mx, fabsf(load_q(p, qrow + d)));
    mx = warp_max(mx);
    const float q_s = mx + 1e-9f;
    const float inv = 127.0f / q_s;
    for (int d = lane; d < D; d += 32)
      qi8[warp * D + d] =
          (int8_t)fminf(fmaxf(rintf(load_q(p, qrow + d) * inv), -127.f), 127.f);
    if (lane == 0) st[warp * NSTAT + 0] = q_s * p.lg_c;
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
        int dots[REP];
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          int d = dot16(k16[u], *reinterpret_cast<const int4*>(qi8 + r * D + sub * 16));
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
#pragma unroll
          for (int r = 0; r < REP; ++r) {
            float x = (float)dots[r] * st[r * NSTAT + 0] * ksc[u];
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
    st[tid * NSTAT + 1] = mx;
  }
  cluster.sync();

  // 4. p and pv = p * v_scale of the share; its sums and pv maxima per block
  if (head < REP) {
    const float m = warp_max(lane < S ? cluster.map_shared_rank(st, lane)[head * NSTAT + 1]
                                      : -INFINITY);
    float lm = 0.f, ls = 0.f, pm = 0.f, ps = 0.f;
    for (int li = seg * 32 + lane; li < cnt; li += WPH * 32) {
      const float pr = expf(lg[head * PER + li] - m);
      float pv;
      if (li < m_end) {
        lm += pr;
        pv = pr * vsb[(long long)(i0 + li) * p.sc.t];
        pm = fmaxf(pm, pv);
      } else {
        ls += pr;
        pv = pr * svsb[(long long)(i0 + li - nmain) * p.ssc.t];
        ps = fmaxf(ps, pv);
      }
      lg[head * PER + li] = pv;
    }
    lm = warp_sum(lm);
    ls = warp_sum(ls);
    pm = warp_max(pm);
    ps = warp_max(ps);
    if (lane == 0) {
      float* rr = red + head * WPH + seg;
      rr[0] = lm;
      rr[RED] = ls;
      rr[2 * RED] = pm;
      rr[3 * RED] = ps;
    }
  }
  __syncthreads();
  if (tid < REP) {
    float lm = 0.f, ls = 0.f, pm = 0.f, ps = 0.f;
    for (int w = 0; w < WPH; ++w) {
      const float* rr = red + tid * WPH + w;
      lm += rr[0];
      ls += rr[RED];
      pm = fmaxf(pm, rr[2 * RED]);
      ps = fmaxf(ps, rr[3 * RED]);
    }
    float* s2 = st + tid * NSTAT;
    s2[2] = lm;
    s2[3] = ls;
    s2[4] = pm;
    s2[5] = ps;
  }
  cluster.sync();

  // 5. the cluster's l, s_p and s_ps; this share's p codes
  if (warp < REP) {
    const float* s2 = lane < S ? cluster.map_shared_rank(st, lane) + warp * NSTAT : nullptr;
    const float lm = warp_sum(s2 ? s2[2] : 0.f), ls = warp_sum(s2 ? s2[3] : 0.f);
    const float pm = warp_max(s2 ? s2[4] : 0.f), ps = warp_max(s2 ? s2[5] : 0.f);
    if (lane == 0) {
      float* g = gs + warp * NGLOB;
      const float s_p = pm + 1e-30f, s_ps = ps + 1e-30f;
      g[0] = lm + ls;
      g[1] = s_p;
      g[2] = s_ps;
      g[3] = 127.0f / s_p;
      g[4] = 127.0f / s_ps;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < REP * cnt; idx += THREADS) {
    const int r = idx / cnt, li = idx - r * cnt;
    const float c = rintf(lg[r * PER + li] * gs[r * NGLOB + (li < m_end ? 3 : 4)]);
    code[r * PER + li] = (int)fminf(fmaxf(c, 0.f), 127.f);
  }
  __syncthreads();

  // 6. PV: a thread owns 16 columns of one V row, U rows in flight; main
  //    keys, then staged
  {
    const int cpr = D >> 4;  // threads per row
    const int c16 = tid % cpr;
    const int rows = THREADS / cpr;
    int a[REP][16];
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int k = 0; k < 16; ++k) a[r][k] = 0;
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
        if (li + u * rows < m_end) add_pv<REP>(a, v[u], code, PER, li + u * rows);
    }
    flush_pv<REP>(a, acc, D, c16, cpr);
    for (int li = m_end + tid / cpr; li < cnt; li += rows)
      add_pv<REP>(a,
                  *reinterpret_cast<const int4*>(svbase + (long long)(i0 + li - nmain) * p.skv.t +
                                                 c16 * 16),
                  code, PER, li);
    flush_pv<REP>(a, acc + REP * D, D, c16, cpr);
  }
  cluster.sync();

  // 7. epilogue, spread over the ranks: the S int32 partials in rank order,
  //    then /127 for the p codes and /127 for the v codes
  for (int idx = rank * THREADS + tid; idx < REP * D; idx += S * THREADS) {
    const int r = idx / D, d = idx - r * D;
    int am = 0, as = 0;
    for (int q = 0; q < S; ++q) {
      const int* ra = cluster.map_shared_rank(acc, q);
      am += ra[r * D + d];
      as += ra[(REP + r) * D + d];
    }
    const float* g = gs + r * NGLOB;
    const float o2 = (float)am * g[1] + (float)as * g[2];
    p.out[((size_t)b * H + hk * REP + r) * D + d] = o2 / (g[0] * 16129.0f);
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

size_t smem_bytes(int rep, int T, int C, int D, int S) {
  const size_t per = ((size_t)T + C + S - 1) / S;
  return pad16((size_t)rep * per * 4) + pad16((size_t)rep * D) + (size_t)2 * rep * D * 4 +
         (size_t)rep * (NSTAT + NGLOB) * 4 + (size_t)4 * RED * 4;
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
