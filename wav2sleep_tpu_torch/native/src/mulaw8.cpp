// mu-law int8 encoder for already-normalized f32 waveforms (the training
// input transport; the inference q8 path quantizes EDF int16 codes instead,
// see edf_decode.cpp).
//
// The port's copy of wav2sleep_tpu/native/src/mulaw8.cpp.
//
// Encoding contract (must match the device decode, dequant_q8 of
// ops/q8_transport.py): for a row with peak p = max|x| over finite samples,
//   code(x) = round( sign(x) * 127 * log(1 + 255*|x|/p) / log(256) )
//   decode(k) = sign(k) * p * (256^(|k|/127) - 1) / 255
// A whole-row non-finite input (the -inf missing-modality sentinel) encodes
// as all-zero codes with present=0; the device decode re-poisons it.
//
// The per-sample encode avoids logf: with t = 1 + 255*|x|/p in [1, 256],
// code = round(127/8 * log2(t)), and the rounding boundaries are fixed
// thresholds in t. The float bits of t index a 8x1024-bucket LUT (exponent
// 0..7, top-10 mantissa bits) holding the bucket's lower-bound code; the
// buckets are ~100x finer than the narrowest code interval, so at most one
// fix-up comparison against the next threshold is needed. ~6 ops/sample,
// one gather.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kCodes = 127;            // codes 0..127 per polarity
constexpr int kBuckets = 8 * 1024;     // 13-bit key space for t in [1,256)
constexpr uint32_t kOneBits = 0x3F800000u;  // bit pattern of 1.0f

struct Tables {
  float thr[kCodes + 2];   // thr[k] = t-threshold where code becomes k
  uint8_t lut[kBuckets + 1];
  Tables() {
    thr[0] = 0.0f;
    for (int k = 1; k <= kCodes; ++k) {
      thr[k] = static_cast<float>(std::exp2((k - 0.5) * 8.0 / kCodes));
    }
    thr[kCodes + 1] = 3.0e38f;  // sentinel: never exceeded
    int k = 0;
    for (int key = 0; key <= kBuckets; ++key) {
      uint32_t bits = kOneBits + (static_cast<uint32_t>(key) << 13);
      float t_lo;
      std::memcpy(&t_lo, &bits, sizeof(t_lo));
      while (k < kCodes && thr[k + 1] <= t_lo) ++k;
      lut[key] = static_cast<uint8_t>(k);
    }
  }
};

const Tables kTables;

}  // namespace

extern "C" {

// Encode one row of n f32 samples to mu-law int8. Writes codes to `out`,
// the row peak to `*peak_out`. Returns 1 when the row has finite samples,
// 0 when the row is entirely non-finite (missing channel: codes zeroed,
// peak 0), and -1 for a MIXED row (finite data plus non-finite samples):
// a per-sample sentinel cannot survive the 1-byte transport — encoding it
// as a full-scale code would turn padding into confident garbage — so the
// caller must reject such rows loudly.
int32_t w2s_mulaw8_encode_f32(const float* x, int64_t n, int8_t* out,
                              float* peak_out) {
  float peak = 0.0f;
  int64_t n_finite = 0;
  for (int64_t i = 0; i < n; ++i) {
    const float v = x[i];
    if (std::isfinite(v)) {
      ++n_finite;
      const float a = std::fabs(v);
      if (a > peak) peak = a;
    }
  }
  if (n_finite == 0) {
    std::memset(out, 0, static_cast<size_t>(n));
    *peak_out = 0.0f;
    return 0;
  }
  if (n_finite < n) {
    *peak_out = 0.0f;
    return -1;
  }
  *peak_out = peak;
  if (peak == 0.0f) peak = 1.0f;  // all-zero row: every code is 0 anyway
  const float inv_peak = 255.0f / peak;
  for (int64_t i = 0; i < n; ++i) {
    const float v = x[i];
    float a = std::fabs(v) * inv_peak;        // in [0, 255]
    float t = 1.0f + (a < 255.0f ? a : 255.0f);
    uint32_t bits;
    std::memcpy(&bits, &t, sizeof(bits));
    const uint32_t key = (bits - kOneBits) >> 13;
    int k = kTables.lut[key];
    k += (t >= kTables.thr[k + 1]);
    out[i] = static_cast<int8_t>(v < 0.0f ? -k : k);
  }
  return 1;
}

}  // extern "C"
