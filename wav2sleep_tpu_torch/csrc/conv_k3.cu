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

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kGelu: return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
    case kRelu: return fmaxf(v, 0.0f);
    case kLeaky: return v >= 0.0f ? v : 0.01f * v;
    case kSilu: return v / (1.0f + expf(-v));
    default: return v;
  }
}

// One block: one batch row, kTT consecutive output times, all CO channels.
template <typename T, int CO, int S>
__global__ void __launch_bounds__(kThreads) conv_k3_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
    const float* __restrict__ mu, const float* __restrict__ inv, T* __restrict__ y,
    int t_in, int t_out, int c_in, int act) {
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
    if (t >= t_out) continue;
    T* yp = y + ((size_t)b * t_out + t) * CO + tc * kChans;
#pragma unroll
    for (int r = 0; r < kChans; ++r) store_from_f32(yp + r, acc[i][r] + bv[r]);
  }
}

template <typename T, int CO, int S>
int launch(const void* x, const void* w, const void* bias, const float* mu, const float* inv,
           void* y, int batch, int t_in, int t_out, int c_in, int act, cudaStream_t stream) {
  constexpr int kTT = (kThreads / (CO / kChans)) * kTimes;
  const dim3 grid((t_out + kTT - 1) / kTT, batch);
  conv_k3_kernel<T, CO, S><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias), mu, inv,
      static_cast<T*>(y), t_in, t_out, c_in, act);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int S>
int dispatch_co(int c_out, const void* x, const void* w, const void* bias, const float* mu,
                const float* inv, void* y, int batch, int t_in, int t_out, int c_in, int act,
                cudaStream_t stream) {
  switch (c_out) {
    case 16: return launch<T, 16, S>(x, w, bias, mu, inv, y, batch, t_in, t_out, c_in, act, stream);
    case 32: return launch<T, 32, S>(x, w, bias, mu, inv, y, batch, t_in, t_out, c_in, act, stream);
    case 64: return launch<T, 64, S>(x, w, bias, mu, inv, y, batch, t_in, t_out, c_in, act, stream);
    case 128: return launch<T, 128, S>(x, w, bias, mu, inv, y, batch, t_in, t_out, c_in, act, stream);
    default: return -1;
  }
}

template <typename T>
int dispatch_stride(int stride, int c_out, const void* x, const void* w, const void* bias,
                    const float* mu, const float* inv, void* y, int batch, int t_in, int t_out,
                    int c_in, int act, cudaStream_t stream) {
  if (stride == 1) return dispatch_co<T, 1>(c_out, x, w, bias, mu, inv, y, batch, t_in, t_out, c_in, act, stream);
  if (stride == 2) return dispatch_co<T, 2>(c_out, x, w, bias, mu, inv, y, batch, t_in, t_out, c_in, act, stream);
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
  if (batch <= 0 || batch > 65535 || t_in <= 0 || t_out <= 0 || c_in <= 0) return -1;
  if ((mu == nullptr) != (inv == nullptr)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_stride<float>(stride, c_out, x, w, bias, mu, inv, y, batch, t_in, t_out, c_in, act, s);
  if (dtype == 1)
    return dispatch_stride<__nv_bfloat16>(stride, c_out, x, w, bias, mu, inv, y, batch, t_in, t_out, c_in, act, s);
  return -1;
}
