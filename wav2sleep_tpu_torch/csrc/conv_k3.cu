// K1: the encoders' kernel-3 1-D convolution, channels-last, for sm_90a.
//
// Replaces wav2sleep_tpu/ops/pallas_conv.py::_conv_kernel (the TPU kernel
// behind sd_conv, sd_conv_blocks and sd_conv_blocks_fused). It computes
//
//     y[b, t, o] = bias[o] + sum_j sum_c w[j, c, o] * phi(x)[b, S*t + j - 1, c]
//
// with S in {1, 2}, phi either the identity or act((x - mu[b, c]) * inv[b, c])
// (the previous layer's instance norm and activation, folded into the input
// read), and zero padding applied to phi(x). Sums run in f32; y is stored in
// x's dtype (f32 or bf16).
//
// What bounds it on an H100: at the 16-channel, 1.2 M-sample shapes each
// output time costs 3 * 16 * 16 FMAs (1,536 FLOPs) against 64 bytes of bf16
// read and written, 24 FLOPs a byte, above the ~20 FLOPs/byte (67 TFLOP/s
// FP32 over 3.35 TB/s) where a CUDA-core kernel stops being bound by HBM
// bandwidth; the wider layers do more FLOPs per byte (in f32 the 16-channel
// layers sit near the ridge). So this kernel is bound by f32 FMA issue and
// by the shared-memory loads feeding it. Its design keeps both down: phi(x) is staged once per block in
// shared memory (norm and activation applied once per element), weights are
// staged beside it, and each thread keeps a 4 x 4 register tile of outputs
// (4 consecutive times x 4 channels), so one shared load of an input row
// feeds 4 FMAs and one float4 weight load feeds 4 times. Tensor cores
// (mma.sync / wgmma) and TMA are not used yet.
//
// K2 (w2s_conv_k3_stats) is the same kernel with a statistics epilogue. It
// replaces wav2sleep_tpu/ops/pallas_conv.py::_conv_stats_kernel: besides y
// it gives the per-(batch, channel) mean and 1/sqrt(var + eps) of y as
// STORED (rounded to x's dtype), so the instance norm that follows needs no
// second pass over y. Each block reduces its own time tile in shared memory
// (sum, then M2 about the tile's mean, in f32) and writes the two to a
// [batch, C_out, n_tiles] scratch; a second small launch merges the tiles in
// a fixed order with Chan's update. No float atomics: results are the same
// from run to run. What it adds to K1 is bytes-cheap (2 floats per channel
// per tile) and a few FLOPs per output, so it is bound as K1 is.
//
// Plain C interface, loaded with ctypes; see ops/conv_k3.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;          // input channels staged per step
constexpr int kTimes = 4;           // consecutive output times per thread
constexpr int kChans = 4;           // output channels per thread
constexpr int kPitch = kChunk + 1;  // staged row pitch; odd to spread banks

enum Act { kLinear = 0, kGelu = 1, kRelu = 2, kLeaky = 3, kSilu = 4 };

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
// v as it reads back after a store in T.
__device__ __forceinline__ float stored(float v, const float*) { return v; }
__device__ __forceinline__ float stored(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kGelu: return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
    case kRelu: return fmaxf(v, 0.0f);
    case kLeaky: return v >= 0.0f ? v : 0.01f * v;
    case kSilu: return v / (1.0f + expf(-v));
    default: return v;
  }
}

template <int CO>
constexpr int tile_times() { return (kThreads / (CO / kChans)) * kTimes; }

// One block: one batch row, kTT consecutive output times, all CO channels.
// With STATS, part[0] and part[1] ([batch, CO, gridDim.x] each) receive the
// tile's per-channel mean and M2 of the stored outputs.
template <typename T, int CO, int S, bool STATS>
__global__ void __launch_bounds__(kThreads) conv_k3_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
    const float* __restrict__ mu, const float* __restrict__ inv, T* __restrict__ y,
    float* __restrict__ part, int t_in, int t_out, int c_in, int act) {
  constexpr int kGroupsC = CO / kChans;            // channel groups per block
  constexpr int kGroupsT = kThreads / kGroupsC;    // time groups per block
  constexpr int kTT = kGroupsT * kTimes;           // output times per block
  constexpr int kRows = kTT * S + 2;               // input window incl. halo
  constexpr int kWin = kTimes * S + 2;             // input rows one thread reads
  __shared__ float xs[kRows * kPitch];
  __shared__ __align__(16) float ws[kChunk * 3 * CO];

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTT;
  const long in0 = (long)t0 * S - 1;  // input time of window row 0
  const int tc = threadIdx.x % kGroupsC;
  const int tt = threadIdx.x / kGroupsC;
  const T* xb = x + (size_t)b * t_in * c_in;
  const float* mub = mu ? mu + (size_t)b * c_in : nullptr;
  const float* invb = inv ? inv + (size_t)b * c_in : nullptr;

  float acc[kTimes][kChans];
#pragma unroll
  for (int i = 0; i < kTimes; ++i)
#pragma unroll
    for (int r = 0; r < kChans; ++r) acc[i][r] = 0.0f;

  for (int c0 = 0; c0 < c_in; c0 += kChunk) {
    // Stage phi(x) for the window's rows and this chunk's channels. Rows
    // outside [0, t_in) are the conv's zero padding of phi(x).
    for (int e = threadIdx.x; e < kRows * kChunk; e += kThreads) {
      const int row = e / kChunk, c = e % kChunk, ch = c0 + c;
      const long t = in0 + row;
      float v = 0.0f;
      if (t >= 0 && t < t_in && ch < c_in) {
        v = load_f32(xb + (size_t)t * c_in + ch);
        if (mub) v = activate((v - mub[ch]) * invb[ch], act);
      }
      xs[row * kPitch + c] = v;
    }
    // Stage weights as ws[(c * 3 + j) * CO + o] = w[j, c0 + c, o].
    for (int e = threadIdx.x; e < kChunk * 3 * CO; e += kThreads) {
      const int o = e % CO, jc = e / CO, j = jc % 3, c = jc / 3, ch = c0 + c;
      ws[e] = ch < c_in ? load_f32(w + ((size_t)j * c_in + ch) * CO + o) : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kChunk; ++c) {
      float xv[kWin];
#pragma unroll
      for (int m = 0; m < kWin; ++m) xv[m] = xs[(tt * kTimes * S + m) * kPitch + c];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float4 wv = *reinterpret_cast<const float4*>(&ws[(c * 3 + j) * CO + tc * kChans]);
#pragma unroll
        for (int i = 0; i < kTimes; ++i) {
          const float v = xv[i * S + j];
          acc[i][0] = fmaf(wv.x, v, acc[i][0]);
          acc[i][1] = fmaf(wv.y, v, acc[i][1]);
          acc[i][2] = fmaf(wv.z, v, acc[i][2]);
          acc[i][3] = fmaf(wv.w, v, acc[i][3]);
        }
      }
    }
    __syncthreads();
  }

  float bv[kChans];
#pragma unroll
  for (int r = 0; r < kChans; ++r) bv[r] = bias ? load_f32(bias + tc * kChans + r) : 0.0f;
#pragma unroll
  for (int i = 0; i < kTimes; ++i) {
    const int t = t0 + tt * kTimes + i;
#pragma unroll
    for (int r = 0; r < kChans; ++r) acc[i][r] = stored(acc[i][r] + bv[r], y);
    if (t >= t_out) continue;
    T* yp = y + ((size_t)b * t_out + t) * CO + tc * kChans;
#pragma unroll
    for (int r = 0; r < kChans; ++r) store_from_f32(yp + r, acc[i][r]);
  }

  if constexpr (STATS) {
    // Per-channel sum over the tile, then M2 about the tile's mean: each
    // thread reduces its kTimes outputs, shared memory the kGroupsT threads
    // of a channel group, in a fixed order.
    __shared__ float red[kGroupsT * CO];
    __shared__ float tmean[CO];
    const int n_valid = min(kTT, t_out - t0);
    const int t_first = t0 + tt * kTimes;
#pragma unroll
    for (int r = 0; r < kChans; ++r) {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < kTimes; ++i) s += t_first + i < t_out ? acc[i][r] : 0.0f;
      red[tt * CO + tc * kChans + r] = s;
    }
    __syncthreads();
    if (threadIdx.x < CO) {
      float s = 0.0f;
      for (int k = 0; k < kGroupsT; ++k) s += red[k * CO + threadIdx.x];
      tmean[threadIdx.x] = s / (float)n_valid;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kChans; ++r) {
      const float m = tmean[tc * kChans + r];
      float q = 0.0f;
#pragma unroll
      for (int i = 0; i < kTimes; ++i) {
        const float d = acc[i][r] - m;
        q += t_first + i < t_out ? d * d : 0.0f;
      }
      red[tt * CO + tc * kChans + r] = q;
    }
    __syncthreads();
    if (threadIdx.x < CO) {
      float q = 0.0f;
      for (int k = 0; k < kGroupsT; ++k) q += red[k * CO + threadIdx.x];
      const size_t o = ((size_t)b * CO + threadIdx.x) * gridDim.x + blockIdx.x;
      const size_t plane = (size_t)gridDim.y * CO * gridDim.x;
      part[o] = tmean[threadIdx.x];
      part[plane + o] = q;
    }
  }
}

// Chan's merge of (n_b, mean_b, m2_b) into (n_a, mean_a, m2_a).
__device__ __forceinline__ void chan_merge(float& n_a, float& mean_a, float& m2_a, float n_b,
                                           float mean_b, float m2_b) {
  if (n_b == 0.0f) return;
  const float n = n_a + n_b;
  const float delta = mean_b - mean_a;
  mean_a += delta * (n_b / n);
  m2_a += m2_b + delta * delta * (n_a * n_b / n);
  n_a = n;
}

constexpr int kMergeThreads = 128;

// One block per (batch, channel): thread j merges tiles j, j + 128, ... in
// order, then a fixed pairwise tree merges the threads.
__global__ void __launch_bounds__(kMergeThreads) merge_stats_kernel(
    const float* __restrict__ part, float* __restrict__ mu, float* __restrict__ inv,
    int rows, int n_tiles, int tile, int t_out, float eps) {
  __shared__ float sn[kMergeThreads], smean[kMergeThreads], sm2[kMergeThreads];
  const int row = blockIdx.x;  // b * CO + c
  const float* pm = part + (size_t)row * n_tiles;
  const float* pq = part + (size_t)rows * n_tiles + (size_t)row * n_tiles;
  float n = 0.0f, mean = 0.0f, m2 = 0.0f;
  for (int k = threadIdx.x; k < n_tiles; k += kMergeThreads)
    chan_merge(n, mean, m2, (float)min(tile, t_out - k * tile), pm[k], pq[k]);
  sn[threadIdx.x] = n;
  smean[threadIdx.x] = mean;
  sm2[threadIdx.x] = m2;
  __syncthreads();
  for (int half = kMergeThreads / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) {
      const int o = threadIdx.x + half;
      chan_merge(sn[threadIdx.x], smean[threadIdx.x], sm2[threadIdx.x], sn[o], smean[o], sm2[o]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    mu[row] = smean[0];
    inv[row] = 1.0f / sqrtf(sm2[0] / sn[0] + eps);
  }
}

// Everything a launch needs besides the template arguments.
struct Args {
  const void *x, *w, *bias;
  const float *mu, *inv;
  void* y;
  float *part, *mu_out, *inv_out;  // K2 only
  int batch, t_in, t_out, c_in, act;
  float eps;
  cudaStream_t stream;
};

template <typename T, int CO, int S, bool STATS>
int launch(const Args& a) {
  constexpr int kTT = tile_times<CO>();
  const dim3 grid((a.t_out + kTT - 1) / kTT, a.batch);
  conv_k3_kernel<T, CO, S, STATS><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w), static_cast<const T*>(a.bias), a.mu,
      a.inv, static_cast<T*>(a.y), a.part, a.t_in, a.t_out, a.c_in, a.act);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || !STATS) return rc;
  merge_stats_kernel<<<a.batch * CO, kMergeThreads, 0, a.stream>>>(
      a.part, a.mu_out, a.inv_out, a.batch * CO, grid.x, kTT, a.t_out, a.eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int S, bool STATS>
int dispatch_co(int c_out, const Args& a) {
  switch (c_out) {
    case 16: return launch<T, 16, S, STATS>(a);
    case 32: return launch<T, 32, S, STATS>(a);
    case 64: return launch<T, 64, S, STATS>(a);
    case 128: return launch<T, 128, S, STATS>(a);
    default: return -1;
  }
}

template <bool STATS>
int dispatch(int dtype, int stride, int c_out, const Args& a) {
  if (a.batch <= 0 || a.batch > 65535 || a.t_in <= 0 || a.t_out <= 0 || a.c_in <= 0) return -1;
  if ((a.mu == nullptr) != (a.inv == nullptr)) return -1;
  if (dtype == 0 && stride == 1) return dispatch_co<float, 1, STATS>(c_out, a);
  if (dtype == 0 && stride == 2) return dispatch_co<float, 2, STATS>(c_out, a);
  if (dtype == 1 && stride == 1) return dispatch_co<__nv_bfloat16, 1, STATS>(c_out, a);
  if (dtype == 1 && stride == 2) return dispatch_co<__nv_bfloat16, 2, STATS>(c_out, a);
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w, bias and y share it); mu/inv are
// float32 [batch, c_in] or both null; bias may be null. Returns 0 on
// success, -1 for an unsupported configuration, otherwise the
// cudaGetLastError() code of the launch.
extern "C" int w2s_conv_k3(const void* x, const void* w, const void* bias, const float* mu,
                           const float* inv, void* y, int batch, int t_in, int t_out, int c_in,
                           int c_out, int stride, int act, int dtype, void* stream) {
  const Args a{x, w, bias, mu, inv, y, nullptr, nullptr, nullptr,
               batch, t_in, t_out, c_in, act, 0.0f, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(dtype, stride, c_out, a);
}

// Output times per block (the stats tile) for c_out; 0 if unsupported.
extern "C" int w2s_conv_k3_tile(int c_out) {
  switch (c_out) {
    case 16: return tile_times<16>();
    case 32: return tile_times<32>();
    case 64: return tile_times<64>();
    case 128: return tile_times<128>();
    default: return 0;
  }
}

// K2: w2s_conv_k3 plus mu_out, inv_out (float32 [batch, c_out]) of y as
// stored; part is float32 scratch of 2 * batch * c_out * n_tiles, with
// n_tiles = ceil(t_out / w2s_conv_k3_tile(c_out)).
extern "C" int w2s_conv_k3_stats(const void* x, const void* w, const void* bias, const float* mu,
                                 const float* inv, void* y, float* part, float* mu_out,
                                 float* inv_out, int batch, int t_in, int t_out, int c_in,
                                 int c_out, int stride, int act, int dtype, float eps,
                                 void* stream) {
  const Args a{x, w, bias, mu, inv, y, part, mu_out, inv_out,
               batch, t_in, t_out, c_in, act, eps, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(dtype, stride, c_out, a);
}
