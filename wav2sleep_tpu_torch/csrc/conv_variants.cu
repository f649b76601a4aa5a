// The K1 bisection ladder: scripts/profile_pallas_variants.py's five kernels
// for sm_90a, at 128 channels in and out, bf16 in, f32 sums, bf16 out.
//
//   V0 (k_copy, :79)   y = x
//   V2 (k_mm1f, :85)   y = x @ W0
//   V3 (k_mm3, :93)    y = x @ W0 + x @ W1 + x @ W2
//   V4 (k_mm3s, :106)  per tile of tb rows: y = x @ W1, plus x @ W0 shifted
//                      down one row, plus x @ W2 shifted up one row, with 0
//                      shifted in at both edges of every tile of tb rows
//   V7 (k_v7, :136)    per tile t of tb rows: y = xm1 @ W0 + x @ W1 + xp1 @ W2
//                      with xm1 = [xp[b, 8t], x[0:tb-1]] and
//                      xp1 = [x[1:tb], xn[b, 8t]]: K1 at 128 -> 128, stride 1,
//                      when the halo rows are the true neighbours
//
// x is [batch, nb, 128], W [taps, 128, 128] used as x @ W[j] (K1's layout),
// xp and xn [batch, (nb / tb) * 8, 128], of which V7 reads row 8t.
//
// What bounds them on an H100: every rung reads x once and writes y once,
// 2 x nb x 256 bytes a batch row, and does 0, 256 or 768 FLOPs a row of 256
// bytes read: at most 192 FLOPs a byte, under the ~295 where the bf16 tensor
// cores (989 TFLOP/s) stop being bound by HBM (3.35 TB/s). So all five are
// bound by bytes, provided the products run on the tensor cores: at x [8,
// 153,600, 128], 0.1878 ms (V7, with its halo rows and W, 0.1879).
//
// Design. V0 is a plain vector copy (below). V2, V3, V4 and V7 are Hopper's
// wgmma fed by TMA, in persistent blocks, in conv_variants_wgmma.cuh (its own
// note says how each does its taps). V7, K1's formulation, shifts on the
// bf16 input side as K1 does: each tap's operand descriptor starts one row
// further into a 66-row window of the tile (inside a swizzle atom, its
// base-offset field 0), and the halo rows are patched into the window in
// shared memory.
//
// V0, the copy: one 16-byte vector per thread (the widest load and store
// a thread has on sm_90a), blocks of 1024 threads, one block per 16 KB of
// x, no loop. Measured on an H100 SXM at 700 W (PERF.md), every
// persistent design ran 5-22% slower than Tensor.copy_ (the runtime's
// device-to-device copy), which reaches 89% of the bound: the grid-stride
// loop of 16-byte vectors this kernel replaces, contiguous spans per block,
// streaming cache hints, L2 prefetch hints, and TMA bulk copies through a
// ring in shared memory in every chunk size, ring depth and chunk order
// tried. Short-lived blocks of single vectors,
// issued in order by the block scheduler, reach copy_'s rate.
//
// Plain C interface, loaded with ctypes; see ops/conv_variants.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "conv_variants_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kChunks = 128 / 8;    // 16-byte chunks per row of 128 bf16
constexpr int kCopyThreads = 1024;  // V0: 16-byte vectors per block

enum Mode { kCopy = 0, kMm1 = 2, kMm3 = 3, kMm3s = 4, kV7 = 7 };

// V0: y = x over n 16-byte vectors, one a thread.
__global__ void __launch_bounds__(kCopyThreads) copy_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
                                                            size_t n) {
  const size_t i = (size_t)blockIdx.x * kCopyThreads + threadIdx.x;
  if (i < n) y[i] = x[i];
}

int launch_copy(const void* x, void* y, size_t n16, cudaStream_t stream) {
  const size_t blocks = (n16 + kCopyThreads - 1) / kCopyThreads;
  if (blocks > 0x7fffffff) return -1;
  copy_kernel<<<static_cast<unsigned>(blocks), kCopyThreads, 0, stream>>>(static_cast<const uint4*>(x),
                                                                          static_cast<uint4*>(y), n16);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// mode: 0 = V0 (copy), 2 = V2, 3 = V3, 4 = V4, 7 = V7 (the last four in
// conv_variants_wgmma.cuh). x, y: bf16 [batch, nb, 128]; w: bf16 [1, 128, 128] for V2, [3, 128, 128] for V3,
// V4, V7, unused by V0; xp, xn: bf16 [batch, (nb / tb) * 8, 128] for V7, else unused. Every
// pointer 16-byte aligned; tb > 0, tb % 8 == 0, nb % tb == 0. Returns 0 on
// success, -1 for an unsupported configuration, otherwise the CUDA error
// code of the launch.
extern "C" int w2s_conv_variant(int mode, const void* x, const void* w, const void* xp, const void* xn, void* y,
                                int batch, int nb, int tb, void* stream) {
  if (batch <= 0 || nb <= 0 || tb <= 0 || tb % 8 != 0 || nb % tb != 0) return -1;
  if (!aligned16(x) || !aligned16(y)) return -1;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto xb = static_cast<const bf16*>(x), wb = static_cast<const bf16*>(w);
  const auto yb = static_cast<bf16*>(y);
  const long rows = (long)batch * nb;
  if (mode == kCopy) return launch_copy(x, y, (size_t)rows * kChunks, s);
  if (w == nullptr || !aligned16(w)) return -1;
  switch (mode) {
    case kMm1: return wgmma_mm::launch<1>(xb, wb, yb, rows, tb, s);
    case kMm3: return wgmma_mm::launch<3>(xb, wb, yb, rows, tb, s);
    case kMm3s: return wgmma_mm::launch<4>(xb, wb, yb, rows, tb, s);
    case kV7:
      if (xp == nullptr || xn == nullptr || !aligned16(xp) || !aligned16(xn)) return -1;
      return wgmma_mm::launch_v7(xb, wb, static_cast<const bf16*>(xp), static_cast<const bf16*>(xn), yb, rows, tb,
                                 s);
    default: return -1;
  }
}
