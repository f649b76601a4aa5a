// K3: causal EMA normalization of signal rows, for sm_90a.
//
// Replaces wav2sleep_tpu/ops/pallas_ema.py::_ema_kernel (the Pallas TPU
// kernel behind ema_normalize_pallas). For each row x[0..n) with its own
// warm-up state (mu0, ss0) and rates (alpha_b, alpha_v), in f32 as the TPU
// kernel computes it:
//
//   out[0] = (x[0] - mu0) * rsqrt(max(ss0, min_ss))         (sample 0 keeps
//                                                            the warm-up state)
//   mu  <- alpha_b * x + (1 - alpha_b) * mu
//   r    = clip(x - mu, -thr * sqrt(max(ss, min_ss)), +thr * sqrt(max(ss, min_ss)))
//   ss  <- alpha_v * r * r + (1 - alpha_v) * ss
//   out  = (x - mu) * rsqrt(max(ss, min_ss))
//
// What bounds it: the clip reads sigma from the previous step, so the
// recurrence is not associative and each row is one serial chain
// (max -> sqrt -> clip -> square -> add per sample, some tens of cycles).
// The work is parallel only across rows, 8 per modality at batch 8, so the
// kernel is bound by the latency of that chain, far above its byte bound
// (8 bytes per sample). What the design does about it: one launch over every
// row of every modality (each row with its own length and rates), so the
// long ECG and PPG rows run side by side with the short ABD and THX rows
// instead of one modality after another; one warp per row, on its own SM,
// so that nothing but the chain is left on the row's critical path: the 32
// lanes read 32 consecutive samples in one coalesced load, walk them
// together (each lane holds the same state; the samples come by shuffle,
// independent of the chain), and lane k writes the output of sample k in
// one coalesced store.
//
// Plain C interface, loaded with ctypes; see ops/ema_norm.py.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kAll = 0xffffffffu;

struct State {
  float mu, ss;
};

// One step, each operation rounded on its own (the _rn intrinsics are never
// contracted into fused multiply-adds), in the plain version's order, so
// the kernel and ops/ema_norm.ema_normalize_reference round alike.
__device__ __forceinline__ float step(State& s, float x, float ab, float omab, float av,
                                      float omav, float thr, float min_ss) {
  s.mu = __fadd_rn(__fmul_rn(ab, x), __fmul_rn(omab, s.mu));
  const float limit = __fmul_rn(thr, __fsqrt_rn(fmaxf(s.ss, min_ss)));
  const float d = __fsub_rn(x, s.mu);
  const float r = fminf(fmaxf(d, -limit), limit);
  s.ss = __fadd_rn(__fmul_rn(__fmul_rn(av, r), r), __fmul_rn(omav, s.ss));
  return __fmul_rn(d, rsqrtf(fmaxf(s.ss, min_ss)));
}

// rows: [n_rows, 3] int64 (input pointer, output pointer, length);
// params: [n_rows, 6] f32 (mu0, ss0, alpha_b, 1 - alpha_b, alpha_v, 1 - alpha_v).
// One block of one warp per row.
__global__ void __launch_bounds__(kWarp) ema_kernel(const long long* __restrict__ rows,
                                                    const float* __restrict__ params, float thr,
                                                    float min_ss) {
  const int row = blockIdx.x, lane = threadIdx.x;
  const float* __restrict__ x = reinterpret_cast<const float*>(rows[3 * row]);
  float* __restrict__ out = reinterpret_cast<float*>(rows[3 * row + 1]);
  const long long n = rows[3 * row + 2];
  const float* p = params + 6 * row;
  const float ab = p[2], omab = p[3], av = p[4], omav = p[5];
  State s{p[0], p[1]};
  // n, t0 and k are the same in every lane, so the warp stays converged.
  for (long long t0 = 0; t0 < n; t0 += kWarp) {
    const float v = t0 + lane < n ? x[t0 + lane] : 0.0f;
    float mine = 0.0f;
    if (t0 > 0 && t0 + kWarp <= n) {
#pragma unroll
      for (int k = 0; k < kWarp; ++k) {
        const float o = step(s, __shfl_sync(kAll, v, k), ab, omab, av, omav, thr, min_ss);
        mine = lane == k ? o : mine;
      }
    } else {  // the first chunk (sample 0 keeps the warm-up state) and a ragged last one
      for (int k = 0; k < kWarp && t0 + k < n; ++k) {
        const float xk = __shfl_sync(kAll, v, k);
        const float o = t0 + k == 0 ? __fmul_rn(__fsub_rn(xk, s.mu), rsqrtf(fmaxf(s.ss, min_ss)))
                                    : step(s, xk, ab, omab, av, omav, thr, min_ss);
        mine = lane == k ? o : mine;
      }
    }
    if (t0 + lane < n) out[t0 + lane] = mine;
  }
}

}  // namespace

// Returns 0 on success, -1 for bad arguments, otherwise the
// cudaGetLastError() code of the launch.
extern "C" int w2s_ema_normalize(const long long* rows, const float* params, int n_rows,
                                 float thr, float min_ss, void* stream) {
  if (n_rows <= 0 || rows == nullptr || params == nullptr) return -1;
  ema_kernel<<<n_rows, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(rows, params, thr, min_ss);
  return static_cast<int>(cudaGetLastError());
}
