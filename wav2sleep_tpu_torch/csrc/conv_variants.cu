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
// bound by bytes, provided the products run on the tensor cores.
//
// Design. V0 is a plain vector copy (below). V2, V3 and V4 are Hopper's wgmma
// fed by TMA, in conv_variants_wgmma.cuh (its own note says why). V7 is
// built from the parts of K1's bf16 main loop (conv_k3.cu,
// conv_k3_mma_kernel at 128 -> 128), so that it bisects K1's own design:
// - mma.sync m16n8k16 fed by ldmatrix, f32 accumulators; 16 warps, 4 in M
//   (16 rows each) x 4 in N (32 columns each): one pass of 64 rows is one
//   item.
// - Persistent blocks (occupancy x SMs) stage the weights once, as
//   [tap][out][in] with a row pitch of 16 x 17 bytes, so ldmatrix reads B
//   without .trans and without bank conflicts; 96 KB for three taps, hence
//   dynamic shared memory above 48 KB.
// - x comes in through a two-slot ring of 16-byte cp.async copies (the next
//   item's rows in flight while this one computes), zero outside [0, nb).
// - y is rounded to bf16 once, staged in shared memory and written in
//   16-byte vectors.
// - V7 shifts on the bf16 INPUT side, as K1 does: tap j of output row i
//   reads staged row i + j through the lane's ldmatrix address, one
//   accumulator; at an edge of the function's tiles (row % tb == 0 for tap
//   0, tb - 1 for tap 2) the lane's address points at the staged halo row
//   (row 8t of xp or xn) instead. The function's tile edges may fall
//   anywhere in an item: tb and the 64-row item need not divide each other.
//   Divisions by tb are a multiply and a shift (FastDiv).
//
// V0, the copy: one 16-byte vector per thread (the widest load and store
// a thread has on sm_90a), blocks of 1024 threads, one block per 16 KB of
// x, no loop. Measured on an H100 SXM at 700 W (PERF.md), every
// persistent design ran 5-22% slower than Tensor.copy_ (the runtime's
// device-to-device copy), which reaches 89% of the bound: the grid-stride
// loop of 16-byte vectors this kernel replaces, contiguous spans per block,
// streaming cache hints, L2 prefetch hints, and TMA bulk copies
// (cp.async.bulk) through a ring in shared memory in every chunk size,
// ring depth and chunk order tried. Short-lived blocks of single vectors,
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
using wgmma_mm::FastDiv;

constexpr int kD = 128;                 // channels in and out
constexpr int kTile = 64;               // rows per item: 4 warps in M x 16
constexpr int kThreads = 512;           // 16 warps
constexpr int kWarpsN = 4;              // warps across the 128 columns
constexpr int kWarpCols = kD / kWarpsN; // 32: four n8 tiles
constexpr int kNT = kWarpCols / 8;
constexpr int kPitch = kD + 8;          // bf16 per staged row: 272 bytes = 16 x 17
constexpr uint32_t kPitchB = 2 * kPitch;
constexpr int kChunks = kD / 8;         // 16-byte chunks per row
constexpr int kWin = kTile + 2;         // staged window: rows t0 - 1 .. t0 + kTile
// Rows 8t of xp (and of xn) one item can need: tiles of the function that
// meet 64 rows, at tb >= 8.
constexpr int kHalo = kTile / 8 + 1;
constexpr int kSlotRows = kWin + 2 * kHalo;
constexpr int kTaps = 3;

constexpr int kCopyThreads = 1024;     // V0: 16-byte vectors per block

enum Mode { kCopy = 0, kMm1 = 2, kMm3 = 3, kMm3s = 4, kV7 = 7 };

// V7's weights, two ring slots and the y tile.
constexpr size_t kV7Smem = 2 * ((size_t)kTaps * kD * kPitch + 2 * (size_t)kSlotRows * kPitch + (size_t)kTile * kPitch);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zero-filled when
// src_bytes is 0.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// V0: y = x over n 16-byte vectors, one a thread.
__global__ void __launch_bounds__(kCopyThreads) copy_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
                                                            size_t n) {
  const size_t i = (size_t)blockIdx.x * kCopyThreads + threadIdx.x;
  if (i < n) y[i] = x[i];
}

// V7. Persistent: block k walks items blockIdx.x + k gridDim.x,
// item = b * n_tiles + t0 / kTile.
__global__ void __launch_bounds__(kThreads, 1) variant_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w, const bf16* __restrict__ xp,
    const bf16* __restrict__ xn, bf16* __restrict__ y, int batch, int nb, FastDiv tb) {
  const int n_tiles = (nb + kTile - 1) / kTile;
  const int n_items = batch * n_tiles;
  const int n_fn = tb.div(nb);  // the function's tiles per batch row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);
  bf16* slots = ws + kTaps * kD * kPitch;
  bf16* ys = slots + 2 * kSlotRows * kPitch;

  // Staged rows of item into slot: the window (window row r is x[t0 - 1 + r],
  // zero outside [0, nb)), then row 8f of xp and of xn for the function's
  // tiles f = t0 / tb, ... that the item's rows meet.
  auto load = [&](int item, int slot) {
    const int b = item / n_tiles;
    const int t0 = (item - b * n_tiles) * kTile;
    const bf16* xb = x + (size_t)b * nb * kD;
    bf16* dst = slots + slot * kSlotRows * kPitch;
    for (int q = tid; q < kWin * kChunks; q += kThreads) {
      const int r = q / kChunks, cc = q % kChunks;
      const long t = (long)t0 - 1 + r;
      const bool ok = t >= 0 && t < nb;
      cp_async16(smem_u32(dst + r * kPitch + cc * 8), ok ? xb + t * kD + cc * 8 : x, ok ? 16 : 0);
    }
    const int f0 = tb.div(t0);
    const int nh = tb.div(min(t0 + kTile, nb) - 1) - f0 + 1;  // <= kHalo
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const bf16* src = (side ? xn : xp) + ((size_t)b * n_fn + f0) * 8 * kD;
      for (int q = tid; q < nh * kChunks; q += kThreads) {
        const int h = q / kChunks, cc = q % kChunks;
        cp_async16(smem_u32(dst + (kWin + side * kHalo + h) * kPitch + cc * 8),
                   src + (size_t)h * 8 * kD + cc * 8, 16);
      }
    }
  };

  load(blockIdx.x, 0);
  cp_async_commit();
  // Weights as ws[(j * kD + o) * kPitch + c] = w[j, c, o].
  for (int e = tid; e < kTaps * kD * kD; e += kThreads) {
    const int o = e % kD, c = (e / kD) % kD, j = e / (kD * kD);
    ws[(j * kD + o) * kPitch + c] = w[e];
  }

  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int n0 = wn * kWarpCols;
  const int arow = wm * 16 + (lane & 15);  // the item row whose A address this lane gives
  const uint32_t a_k = (lane >> 4) * 16;   // and its k offset, bytes
  // B: two n8 tiles per ldmatrix x4, rows n0 + (lane & 7) + (lane >> 4) * 8
  // at k offset ((lane >> 3) & 1) * 8.
  const uint32_t b_lane = (n0 + (lane & 7) + ((lane >> 4) << 3)) * kPitchB + ((lane >> 3) & 1) * 16;
  const int g = lane >> 2, tq = lane & 3;  // accumulator row and column pair
  const int row0 = wm * 16 + g;            // the lane's accumulator rows: row0 and row0 + 8
  const uint32_t ws_a = smem_u32(ws);

  for (int k = 0, item = blockIdx.x; item < n_items; ++k, item += gridDim.x) {
    if (item + (int)gridDim.x < n_items) load(item + gridDim.x, (k + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: item k has landed
    __syncthreads();
    const int b = item / n_tiles, t0 = (item - b * n_tiles) * kTile;
    const uint32_t xs_a = smem_u32(slots + (k & 1) * kSlotRows * kPitch);

    // Staged row that tap j of the lane's row reads.
    auto a_row = [&](int j) -> int {
      const int r = t0 + arow;
      if (r < nb && j != 1) {
        const int f = tb.div(r), rem = r - f * tb.d;
        if (j == 0 && rem == 0) return kWin + f - tb.div(t0);
        if (j == 2 && rem == tb.d - 1) return kWin + kHalo + f - tb.div(t0);
      }
      return arow + j;
    };

    float acc[kNT][4] = {};
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
      const uint32_t a_tap = xs_a + a_row(j) * kPitchB + a_k;
      const uint32_t b_tap = ws_a + j * kD * kPitchB + b_lane;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        uint32_t bf[kNT / 2][4];
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) ldmatrix_x4(bf[np], b_tap + np * 16 * kPitchB + kk * 32);
        uint32_t af[4];
        ldmatrix_x4(af, a_tap + kk * 32);
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni) mma_bf16(acc[ni], af, bf[ni / 2][2 * (ni & 1)], bf[ni / 2][2 * (ni & 1) + 1]);
      }
    }

    // One rounding to bf16, into the staged y tile.
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni) {
      const int col = n0 + ni * 8 + 2 * tq;
      *reinterpret_cast<__nv_bfloat162*>(ys + row0 * kPitch + col) = __floats2bfloat162_rn(acc[ni][0], acc[ni][1]);
      *reinterpret_cast<__nv_bfloat162*>(ys + (row0 + 8) * kPitch + col) =
          __floats2bfloat162_rn(acc[ni][2], acc[ni][3]);
    }
    __syncthreads();

    // The item's rows are contiguous in y: 16-byte stores.
    const int n_valid = min(kTile, nb - t0);
    bf16* yb = y + ((size_t)b * nb + t0) * kD;
    for (int q = tid; q < n_valid * kChunks; q += kThreads) {
      const int r = q / kChunks, cc = q % kChunks;
      *reinterpret_cast<uint4*>(yb + (size_t)q * 8) = *reinterpret_cast<const uint4*>(ys + r * kPitch + cc * 8);
    }
  }
  cp_async_wait<0>();
}

// SMs of the current device.
int device_sms(int* sms) {
  int dev = 0, rc = 0;
  if ((rc = static_cast<int>(cudaGetDevice(&dev))) != 0) return rc;
  return static_cast<int>(cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev));
}

int launch_v7(const bf16* x, const bf16* w, const bf16* xp, const bf16* xn, bf16* y, int batch, int nb, int tb,
              cudaStream_t stream) {
  const long items = (long)batch * ((nb + kTile - 1) / kTile);
  if (items >= (1L << 30)) return -1;  // item + gridDim.x stays an int
  const void* kernel = reinterpret_cast<const void*>(variant_kernel);
  int sms = 0, per_sm = 0, rc = 0;
  if ((rc = device_sms(&sms)) != 0 ||
      (rc = static_cast<int>(
           cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kV7Smem)))) != 0 ||
      (rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kV7Smem))) != 0)
    return rc;
  const long blocks = (long)per_sm * sms;
  if (blocks < 1) return -1;
  const int grid = static_cast<int>(items < blocks ? items : blocks);
  variant_kernel<<<grid, kThreads, kV7Smem, stream>>>(x, w, xp, xn, y, batch, nb, wgmma_mm::make_fast_div(tb));
  return static_cast<int>(cudaGetLastError());
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

// mode: 0 = V0 (copy), 2 = V2, 3 = V3, 4 = V4 (the last three in
// conv_variants_wgmma.cuh), 7 = V7. x, y: bf16 [batch, nb, 128]; w: bf16 [1, 128, 128] for V2, [3, 128, 128] for V3,
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
      return launch_v7(xb, wb, static_cast<const bf16*>(xp), static_cast<const bf16*>(xn), yb, batch, nb, tb, s);
    default: return -1;
  }
}
