// Host-side NF4/FP4 quantize-and-pack and row-wise int8 on CPU threads.
//
// Converting an f32 checkpoint to packed 4-bit codes is host work: the
// weights need not reach the device first. Loaded by
// tpu_bitsandbytes_torch/utils/native.py through ctypes (a plain C ABI, no
// PyTorch headers), built there at first use with the host C++ compiler.
//
// Exposed C ABI:
//   tbnb_quantize_4bit_2d   fp32 [N,K] -> packed nibbles + per-block absmax
//   tbnb_dequantize_4bit_2d inverse
//   tbnb_quantize_rowwise   fp32 [N,K] -> int8 + per-row scales
//
// Semantics bit-match tpu_bitsandbytes_torch.functional.quantize_4bit (the
// row-wise 2D path): K padded to blocksize, absmax clamped at 1e-8, each
// value divided by its block's absmax (one IEEE division, as quantize_4bit
// divides; a product with the reciprocal differs in the last bit and flips
// a few codes in a weight of millions), nearest codebook entry with the
// first index winning ties, lo | hi<<4 packing.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

constexpr float kNF4[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f,
    0.33791524171829224f, 0.44070982933044434f, 0.5626170039176941f,
    0.7229568362236023f, 1.0f};

constexpr float kFP4[16] = {
    0.0f, 0.0625f, 0.125f, 0.25f, 0.375f, 0.5f, 0.75f, 1.0f,
    -0.0f, -0.0625f, -0.125f, -0.25f, -0.375f, -0.5f, -0.75f, -1.0f};

inline uint8_t nearest_code(float x, const float* cb) {
  // first-occurrence tie-break, as functional._nearest_code
  uint8_t best = 0;
  float best_diff = std::fabs(x - cb[0]);
  for (int i = 1; i < 16; ++i) {
    float d = std::fabs(x - cb[i]);
    if (d < best_diff) {
      best_diff = d;
      best = static_cast<uint8_t>(i);
    }
  }
  return best;
}

void parallel_rows(int64_t n, int num_threads,
                   const std::function<void(int64_t, int64_t)>& fn) {
  if (num_threads <= 1 || n < 2) {
    fn(0, n);
    return;
  }
  num_threads = std::min<int64_t>(num_threads, n);
  std::vector<std::thread> threads;
  int64_t chunk = (n + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min<int64_t>(lo + chunk, n);
    if (lo >= hi) break;
    threads.emplace_back(fn, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// in:  [n, k] fp32 row-major
// out: packed [n, k_padded/2] uint8; absmax [n, k_padded/blocksize] fp32
// quant_type: 0 = nf4, 1 = fp4. Returns 0 on success.
int tbnb_quantize_4bit_2d(const float* in, int64_t n, int64_t k,
                          int64_t blocksize, int quant_type, uint8_t* packed,
                          float* absmax, int num_threads) {
  if (blocksize <= 0 || (blocksize & (blocksize - 1)) != 0 ||
      blocksize > 65536)
    return 1;
  const float* cb = quant_type == 0 ? kNF4 : kFP4;
  int64_t k_padded = ((k + blocksize - 1) / blocksize) * blocksize;
  if (k_padded % 2 != 0) k_padded += blocksize;
  int64_t nblocks = k_padded / blocksize;
  int64_t packed_k = k_padded / 2;

  parallel_rows(n, num_threads, [&](int64_t row_lo, int64_t row_hi) {
    std::vector<float> rowbuf(k_padded, 0.0f);
    std::vector<uint8_t> codes(k_padded);
    for (int64_t r = row_lo; r < row_hi; ++r) {
      std::memcpy(rowbuf.data(), in + r * k, sizeof(float) * k);
      std::fill(rowbuf.begin() + k, rowbuf.end(), 0.0f);
      for (int64_t b = 0; b < nblocks; ++b) {
        float am = 0.0f;
        const float* blk = rowbuf.data() + b * blocksize;
        for (int64_t j = 0; j < blocksize; ++j)
          am = std::max(am, std::fabs(blk[j]));
        am = std::max(am, 1e-8f);
        absmax[r * nblocks + b] = am;
        for (int64_t j = 0; j < blocksize; ++j)
          codes[b * blocksize + j] = nearest_code(blk[j] / am, cb);
      }
      uint8_t* prow = packed + r * packed_k;
      for (int64_t j = 0; j < packed_k; ++j)
        prow[j] = static_cast<uint8_t>(codes[2 * j] | (codes[2 * j + 1] << 4));
    }
  });
  return 0;
}

int tbnb_dequantize_4bit_2d(const uint8_t* packed, const float* absmax,
                            int64_t n, int64_t k, int64_t blocksize,
                            int quant_type, float* out, int num_threads) {
  const float* cb = quant_type == 0 ? kNF4 : kFP4;
  int64_t k_padded = ((k + blocksize - 1) / blocksize) * blocksize;
  if (k_padded % 2 != 0) k_padded += blocksize;
  int64_t nblocks = k_padded / blocksize;
  int64_t packed_k = k_padded / 2;

  parallel_rows(n, num_threads, [&](int64_t row_lo, int64_t row_hi) {
    for (int64_t r = row_lo; r < row_hi; ++r) {
      const uint8_t* prow = packed + r * packed_k;
      for (int64_t j = 0; j < k; ++j) {
        uint8_t byte = prow[j / 2];
        uint8_t code = (j % 2 == 0) ? (byte & 0x0F) : (byte >> 4);
        out[r * k + j] = cb[code] * absmax[r * nblocks + j / blocksize];
      }
    }
  });
  return 0;
}

int tbnb_quantize_rowwise(const float* in, int64_t n, int64_t k, int8_t* out,
                          float* scales, int num_threads) {
  parallel_rows(n, num_threads, [&](int64_t row_lo, int64_t row_hi) {
    for (int64_t r = row_lo; r < row_hi; ++r) {
      const float* row = in + r * k;
      float am = 0.0f;
      for (int64_t j = 0; j < k; ++j) am = std::max(am, std::fabs(row[j]));
      am = std::max(am, 1e-8f);
      scales[r] = am;
      float s = 127.0f / am;
      for (int64_t j = 0; j < k; ++j) {
        float q = std::nearbyint(row[j] * s);
        q = std::max(-127.0f, std::min(127.0f, q));
        out[r * k + j] = static_cast<int8_t>(q);
      }
    }
  });
  return 0;
}

}  // extern "C"
