// K3: causal EMA normalization of signal rows, for sm_90a.
//
// Replaces wav2sleep_tpu/ops/pallas_ema.py::_ema_kernel (the Pallas TPU
// kernel behind ema_normalize_pallas). For each row x[0..n) with its own
// warm-up state (mu0, ss0) and rates (alpha_b, alpha_v), in f32:
//
//   out[0] = (x[0] - mu0) * rsqrt(max(ss0, min_ss))         (sample 0 keeps
//                                                            the warm-up state)
//   mu  <- alpha_b * x + (1 - alpha_b) * mu
//   d    = x - mu
//   ss  <- min(alpha_v * d * d, max(c * ss, c * min_ss)) + (1 - alpha_v) * ss
//   out  = d * rsqrt(max(ss, min_ss))
//
// with c = alpha_v * thr**2. This is the TPU kernel's clipped update
// ss <- alpha_v * clip(d, +-thr sqrt(m))**2 + (1 - alpha_v) * ss, m =
// max(ss, min_ss), without the square root: in real numbers clip(d, +-thr
// sqrt(m))**2 = min(d**2, thr**2 m), and alpha_v (> 0) and c (> 0) pass
// through min and max. In f32 the two forms differ by the rounding of sqrt
// and of the squared clip (under 1e-5 on |z| up to ~100); since f32 rounding
// is monotone, this form also rounds exactly as alpha_v * min(d * d, thr**2
// * m) whenever thr**2 is a power of two (the default threshold 4).
//
// What bounds it: the clip reads sigma from the previous step, so the
// recurrence is not associative and each row is one serial chain. The work is
// parallel only across rows (8 per modality at batch 8, 32 in all), so the
// kernel is bound by the latency of that chain, far above its byte bound
// (8 bytes per sample). What the design does about it:
// - The chain on ss is four dependent f32 operations a step (mul, max, min,
//   add), each rounded on its own (the _rn intrinsics are never contracted
//   into fused multiply-adds); the IEEE sqrt of the first version is gone.
// - mu does not depend on ss, so it is walked one chunk of 32 samples ahead:
//   the mu walk of chunk c + 1 runs beside the ss walk of chunk c, two
//   independent chains in one instruction stream. After its mu walk, lane k
//   holds mu after its own sample and computes d and alpha_v d d for it;
//   the ss walk reads them by shuffle, all 32 shuffled before the walk so no
//   shuffle latency sits on a chain.
// - One warp per row, on its own SM, one launch for every row of every
//   modality (each row with its own length and rates), so the long ECG and
//   PPG rows run beside the short ABD and THX rows. Lane k keeps its own
//   sample's ss (a select, off the chain), computes its output once, after
//   the walk, and the warp stores 32 outputs in one coalesced store.
// - The loads of the next kAhead chunks are in flight while a chunk is
//   walked (a register ring), so the chains never wait for memory.
// - The first chunk (sample 0 keeps the warm-up state) and a ragged last one
//   take a plain per-sample walk.
//
// Measured (python -m wav2sleep_tpu_torch.bench_ema and chip_smoke.py phase
// 5, NVIDIA H100 80GB HBM3, 700 W): one serving batch's 32 rows (8 ten-hour
// nights x 4 modalities) in ~23 ms, ~19 ns (~37 cycles) a step of the
// 1,228,800-sample rows, from ~80 ms with the sqrt on the chain. The chain
// takes twice the ~16 cycles its four operations need alone; PERF.md.
//
// Plain C interface, loaded with ctypes; see ops/ema_norm.py.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kAhead = 4;  // chunks of 32 samples loaded ahead of the walk
constexpr unsigned kAll = 0xffffffffu;

struct Rates {
  float ab, omab, av, omav, c, c_floor;
};

// One step, in the plain version's order (ops/ema_norm.ema_normalize_reference),
// so the two round alike. Returns d = x - mu after the update of mu.
__device__ __forceinline__ float step(float& mu, float& ss, float x, const Rates& q) {
  mu = __fadd_rn(__fmul_rn(q.ab, x), __fmul_rn(q.omab, mu));
  const float d = __fsub_rn(x, mu);
  const float avdd = __fmul_rn(q.av, __fmul_rn(d, d));
  ss = __fadd_rn(fminf(avdd, fmaxf(__fmul_rn(q.c, ss), q.c_floor)), __fmul_rn(q.omav, ss));
  return d;
}

// Walk samples k0..cnt-1 of a chunk whose sample k lane k holds in v; lane k
// keeps its sample's d and ss. cnt and k0 are the same in every lane.
__device__ __forceinline__ void walk(float v, int k0, int cnt, int lane, float& mu, float& ss, const Rates& q,
                                     float& my_d, float& my_ss) {
  for (int k = k0; k < cnt; ++k) {
    const float d = step(mu, ss, __shfl_sync(kAll, v, k), q);
    my_d = lane == k ? d : my_d;
    my_ss = lane == k ? ss : my_ss;
  }
}

// rows: [n_rows, 3] int64 (input pointer, output pointer, length);
// params: [n_rows, 8] f32 (mu0, ss0, alpha_b, 1 - alpha_b, alpha_v,
// 1 - alpha_v, c = alpha_v * thr**2, c * min_ss). One block of one warp per row.
__global__ void __launch_bounds__(kWarp) ema_kernel(const long long* __restrict__ rows,
                                                    const float* __restrict__ params, float min_ss) {
  const int row = blockIdx.x, lane = threadIdx.x;
  const float* __restrict__ x = reinterpret_cast<const float*>(rows[3 * row]);
  float* __restrict__ out = reinterpret_cast<float*>(rows[3 * row + 1]);
  const long long n = rows[3 * row + 2];
  const float* p = params + 8 * row;
  const Rates q{p[2], p[3], p[4], p[5], p[6], p[7]};
  float mu = p[0], ss = p[1];
  const long long n_full = n / kWarp;  // whole chunks

  // The first chunk: sample 0 keeps the warm-up state.
  {
    const int cnt = n < kWarp ? static_cast<int>(n) : kWarp;
    const float v = lane < cnt ? x[lane] : 0.0f;
    float my_d = __fsub_rn(v, mu), my_ss = ss;
    walk(v, 1, cnt, lane, mu, ss, q, my_d, my_ss);
    if (lane < cnt) out[lane] = __fmul_rn(my_d, rsqrtf(fmaxf(my_ss, min_ss)));
  }

  // Whole chunks 1 .. n_full - 1: the mu walk of chunk c + 1 beside the ss
  // walk of chunk c. Chunk c + 1's samples were loaded kAhead chunks earlier.
  float ring[kAhead];
#pragma unroll
  for (int a = 0; a < kAhead; ++a) ring[a] = 2 + a < n_full ? x[(2 + a) * kWarp + lane] : 0.0f;
  float d_cur = 0.0f, avdd_cur = 0.0f;
  if (n_full > 1) {  // the mu walk of chunk 1 alone
    const float xv = x[kWarp + lane];
    const float abx = __fmul_rn(q.ab, xv);
    float my_mu = 0.0f;
#pragma unroll
    for (int k = 0; k < kWarp; ++k) {
      mu = __fadd_rn(__shfl_sync(kAll, abx, k), __fmul_rn(q.omab, mu));
      my_mu = lane == k ? mu : my_mu;
    }
    d_cur = __fsub_rn(xv, my_mu);
    avdd_cur = __fmul_rn(q.av, __fmul_rn(d_cur, d_cur));
  }
  for (long long c0 = 1; c0 < n_full; c0 += kAhead) {
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const long long c = c0 + a;
      if (c >= n_full) break;
      const float xn = ring[a];  // chunk c + 1 (zero past the whole chunks)
      ring[a] = c + 1 + kAhead < n_full ? x[(c + 1 + kAhead) * kWarp + lane] : 0.0f;
      const float abx = __fmul_rn(q.ab, xn);
      // Every lane's inputs first, so no shuffle's latency is on a chain.
      float abx_k[kWarp], avdd_k[kWarp];
#pragma unroll
      for (int k = 0; k < kWarp; ++k) {
        abx_k[k] = __shfl_sync(kAll, abx, k);
        avdd_k[k] = __shfl_sync(kAll, avdd_cur, k);
      }
      float mu_n = mu, my_mu = 0.0f, my_ss = 0.0f;
#pragma unroll
      for (int k = 0; k < kWarp; ++k) {
        mu_n = __fadd_rn(abx_k[k], __fmul_rn(q.omab, mu_n));
        ss = __fadd_rn(fminf(avdd_k[k], fmaxf(__fmul_rn(q.c, ss), q.c_floor)), __fmul_rn(q.omav, ss));
        const bool mine = lane == k;
        my_mu = mine ? mu_n : my_mu;
        my_ss = mine ? ss : my_ss;
      }
      out[c * kWarp + lane] = __fmul_rn(d_cur, rsqrtf(fmaxf(my_ss, min_ss)));
      if (c + 1 < n_full) {
        mu = mu_n;
        d_cur = __fsub_rn(xn, my_mu);
        avdd_cur = __fmul_rn(q.av, __fmul_rn(d_cur, d_cur));
      }
    }
  }

  // A ragged last chunk after the first.
  const int tail = static_cast<int>(n - n_full * kWarp);
  if (n_full >= 1 && tail > 0) {
    const long long t0 = n_full * kWarp;
    const float v = lane < tail ? x[t0 + lane] : 0.0f;
    float my_d = 0.0f, my_ss = 0.0f;
    walk(v, 0, tail, lane, mu, ss, q, my_d, my_ss);
    if (lane < tail) out[t0 + lane] = __fmul_rn(my_d, rsqrtf(fmaxf(my_ss, min_ss)));
  }
}

}  // namespace

// Returns 0 on success, -1 for bad arguments, otherwise the
// cudaGetLastError() code of the launch.
extern "C" int w2s_ema_normalize(const long long* rows, const float* params, int n_rows, float min_ss,
                                 void* stream) {
  if (n_rows <= 0 || rows == nullptr || params == nullptr) return -1;
  ema_kernel<<<n_rows, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(rows, params, min_ss);
  return static_cast<int>(cudaGetLastError());
}
