// Fused EDF channel decode + resample, on the host.
//
// The port's copy of wav2sleep_tpu/native/src/edf_decode.cpp, for the two
// transports the port serves: w2s_decode_resample (f32 rows for
// pipeline.NightDecoder) and w2s_resample_q8 (mu-law int8 rows for
// pipeline.Q8NightExtractor). Both read int16 samples of one channel
// straight out of the strided EDF record matrix (records x
// samples-per-record) and linearly interpolate onto the model's uniform
// grid in one pass.
//
// phys = (dig - dig_min) * bitvalue + phys_min   (edflib convention)
// norm = phys * scale + offset                    (mV / [-1,1] mapping)
// out[j] = lerp(sig, grid_j * fs) with zero outside [0, n-1].

#include <cmath>
#include <cstdint>

namespace {

// Incremental-cursor lerp loop of the q8 transport: walks the
// right-aligned grid pos_j = (j+1)*ratio, maintaining i0's (record, offset)
// decomposition by carrying (no per-sample integer divisions — those
// dominated the loop at ~28 ns/sample and blocked all ILP), reading v1
// across record boundaries, and handing each in-range lerped value to
// ``store(j, v)``. Returns n_valid; callers zero the tail (they own the
// output type).
template <typename Store>
int64_t resample_cursor_loop(const int16_t* records, int64_t n_records,
                             int64_t record_stride, int64_t ch_offset,
                             int64_t ch_spr, double ratio, int64_t m,
                             Store&& store) {
  const int64_t n = n_records * ch_spr;
  int64_t n_valid = m;
  int64_t rec = 0, within = 0, i_last = 0;
  for (int64_t j = 0; j < m; ++j) {
    const double pos = (static_cast<double>(j) + 1.0) * ratio;
    if (pos > static_cast<double>(n - 1)) {
      n_valid = j;
      break;
    }
    const int64_t i0 = static_cast<int64_t>(pos);
    within += i0 - i_last;
    i_last = i0;
    while (within >= ch_spr) { within -= ch_spr; ++rec; }
    const int16_t* row = records + rec * record_stride + ch_offset;
    const double v0 = static_cast<double>(row[within]);
    double v1;
    if (within + 1 < ch_spr) v1 = static_cast<double>(row[within + 1]);
    else if (rec + 1 < n_records) v1 = static_cast<double>(row[record_stride]);
    else v1 = v0;
    const double frac = pos - static_cast<double>(i0);
    store(j, v0 + frac * (v1 - v0));
  }
  return n_valid;
}

// Per-channel digital peak over the raw samples (min 1 so the mu-law
// normalization never divides by zero on an all-zero channel).
int32_t digital_peak(const int16_t* records, int64_t n_records,
                     int64_t record_stride, int64_t ch_offset, int64_t ch_spr) {
  int32_t vmax_i = 1;
  for (int64_t r = 0; r < n_records; ++r) {
    const int16_t* row = records + r * record_stride + ch_offset;
    for (int64_t k = 0; k < ch_spr; ++k) {
      int32_t a = row[k];
      if (a < 0) a = -a;
      if (a > vmax_i) vmax_i = a;
    }
  }
  return vmax_i;
}

// mu-law int8 quantization LUT over the int16 digital range (mu=255),
// slot-cached per digital peak V: a batch interleaves channels with
// distinct Vs every night, so a single-entry cache would rebuild 65536
// log1p entries per channel per night.
constexpr int kLutSlots = 8;

const int8_t* q8_lut_for_peak(double V) {
  static thread_local int8_t luts[kLutSlots][65536];
  static thread_local double lut_Vs[kLutSlots] = {-1, -1, -1, -1, -1, -1, -1, -1};
  static thread_local int lut_next = 0;
  const double mu = 255.0;
  const double inv_log1p_mu = 1.0 / std::log1p(mu);
  for (int s = 0; s < kLutSlots; ++s) {
    if (lut_Vs[s] == V) return luts[s];
  }
  const int slot = lut_next;
  lut_next = (lut_next + 1) % kLutSlots;
  int8_t* l = luts[slot];
  for (int32_t d = -32768; d < 32768; ++d) {
    const double x = static_cast<double>(d < 0 ? -d : d) / V;
    const double q = 127.0 * std::log1p(mu * (x > 1.0 ? 1.0 : x)) * inv_log1p_mu;
    const int32_t qi = static_cast<int32_t>(std::lrint(q));
    l[static_cast<uint16_t>(d)] = static_cast<int8_t>(d < 0 ? -qi : qi);
  }
  lut_Vs[slot] = V;
  return l;
}

}  // namespace

extern "C" {

void w2s_decode_resample(
    const int16_t* records,   // base of the EDF data area (memmap)
    int64_t n_records,        // number of data records
    int64_t record_stride,    // total int16 samples per record (all channels)
    int64_t ch_offset,        // this channel's offset within a record
    int64_t ch_spr,           // this channel's samples per record
    double dig_min, double bitvalue, double phys_min,
    double scale, double offset,   // channel normalization affine
    double fs,                // sampling frequency (Hz)
    const double* grid,       // target timestamps (seconds), length m
    int64_t m,
    float* out)               // output, length m
{
  const int64_t n = n_records * ch_spr;
  if (n <= 0) {
    for (int64_t j = 0; j < m; ++j) out[j] = 0.0f;
    return;
  }
  // Fold digital->physical->normalized into one affine: v = dig * a + b.
  const double a = bitvalue * scale;
  const double b = (phys_min - dig_min * bitvalue) * scale + offset;

  auto sample = [&](int64_t i) -> double {
    const int64_t rec = i / ch_spr;
    const int64_t within = i - rec * ch_spr;
    return static_cast<double>(records[rec * record_stride + ch_offset + within]);
  };

  for (int64_t j = 0; j < m; ++j) {
    const double pos = grid[j] * fs;
    if (pos < 0.0 || pos > static_cast<double>(n - 1)) {
      out[j] = 0.0f;
      continue;
    }
    const int64_t i0 = static_cast<int64_t>(pos);
    const double frac = pos - static_cast<double>(i0);
    const double v0 = sample(i0);
    const double v1 = (i0 + 1 < n) ? sample(i0 + 1) : v0;
    out[j] = static_cast<float>((v0 + frac * (v1 - v0)) * a + b);
  }
}

// mu-law int8 transport: resample one channel onto the model's uniform grid
// in the digital (int16) domain, pos_j = (j+1) * step * fs (right-aligned
// grid), round to int16 and compand to int8 with mu=255 against the
// per-channel digital peak V (returned via *out_vmax). Returns n_valid, the
// grid points inside the recording; the rest are 0.
// Standard biosignal/audio companding: ~4.4% relative error at full scale,
// near-LSB absolute error for small amplitudes — matched to the bf16
// compute precision downstream while shipping half the bytes of int16.
// Quantization uses a 65536-entry LUT over the int16 digital range, so the
// per-sample cost is one lerp + one table lookup.
int64_t w2s_resample_q8(
    const int16_t* records,
    int64_t n_records,
    int64_t record_stride,
    int64_t ch_offset,
    int64_t ch_spr,
    double fs,
    double step,
    int64_t m,
    int8_t* out,
    double* out_vmax)
{
  const int64_t n = n_records * ch_spr;
  if (n <= 0) {
    for (int64_t j = 0; j < m; ++j) out[j] = 0;
    *out_vmax = 1.0;
    return 0;
  }
  // Pass 1: per-channel digital peak over the raw samples.
  const double V =
      static_cast<double>(digital_peak(records, n_records, record_stride, ch_offset, ch_spr));
  *out_vmax = V;
  const int8_t* lut = q8_lut_for_peak(V);
  const double ratio = step * fs;
  if (ratio == 1.0) {
    const int64_t n_valid = (n - 1 < m) ? (n - 1) : m;
    for (int64_t j = 0; j < n_valid; ++j) {
      const int64_t i = j + 1;
      const int64_t rec = i / ch_spr;
      out[j] = lut[static_cast<uint16_t>(records[rec * record_stride + ch_offset + (i - rec * ch_spr)])];
    }
    for (int64_t k = n_valid; k < m; ++k) out[k] = 0;
    return n_valid;
  }
  const int64_t n_valid = resample_cursor_loop(
      records, n_records, record_stride, ch_offset, ch_spr, ratio, m,
      [&](int64_t j, double v) {
        out[j] = lut[static_cast<uint16_t>(static_cast<int16_t>(std::lrint(v)))];
      });
  for (int64_t k = n_valid; k < m; ++k) out[k] = 0;
  return n_valid;
}

}  // extern "C"
