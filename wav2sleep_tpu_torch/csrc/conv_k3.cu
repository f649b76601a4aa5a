// K1 and K2: the encoders' kernel-3 1-D convolution, channels-last, for sm_90a.
//
// K1 (w2s_conv_k3) replaces wav2sleep_tpu/ops/pallas_conv.py::_conv_kernel
// (the TPU kernel behind sd_conv, sd_conv_blocks and sd_conv_blocks_fused):
//
//     y[b, t, o] = bias[o] + sum_j sum_c w[j, c, o] * phi(x)[b, S*t + j - 1, c]
//
// with S in {1, 2}, phi either the identity or act((x - mu[b, c]) * inv[b, c])
// (the previous layer's instance norm and activation, folded into the input
// read), and zero padding applied to phi(x). Sums run in f32; y is stored in
// x's dtype (f32 or bf16).
//
// K2 (w2s_conv_k3_stats) replaces pallas_conv.py::_conv_stats_kernel: K1 plus
// the per-(batch, channel) mean and 1/sqrt(var + eps) of y as STORED (rounded
// to x's dtype), so the instance norm that follows needs no second pass over
// y. Each tile reduces its own outputs (sum, then M2 about the tile's mean,
// in f32, in a fixed order) into a [2, batch, C_out, n_tiles] scratch; a
// second small launch merges the tiles in a fixed order with Chan's update.
// No float atomics: results are the same from run to run.
//
// What bounds it on an H100. Per output time a conv does 6 C_in C_out FLOPs
// and moves at least 2 (S C_in + C_out) bytes in bf16: from 24 FLOPs a byte
// at 16->16 to 192 at 128->128, all under the ~295 FLOPs a byte where the
// bf16 tensor cores (989 TFLOP/s) stop being bound by HBM (3.35 TB/s). So
// every bf16 shape is bound by bytes, provided its products run on the
// tensor cores: on the CUDA cores (67 TFLOP/s, ~20 FLOPs a byte) all but
// the 16-channel shapes would be bound by the FMA rate instead.
//
// bf16 design (conv_k3_mma_kernel): three implicit GEMMs, one per tap, read
// from one staged tile of phi(x) at shifted row addresses.
// - Tensor cores through mma.sync m16n8k16 (bf16 in, f32 sums), fed by
//   ldmatrix. A tap shift is a row offset of the ldmatrix addresses; at
//   stride 2 the staged rows are de-interleaved (even window rows, then odd
//   ones), so every tap reads consecutive rows: no im2col, no copy.
// - Persistent blocks (occupancy x SMs; 512 threads at C_out 128, else
//   256) walk (batch, time-tile) items and stage the weights once per block
//   as [tap][C_out][C_in] (zero-padded to a multiple of 16 channels), the
//   layout ldmatrix reads B from without .trans. Re-reading the weights for
//   every tile is what lost the wide shapes to cuDNN before.
// - x tiles (S * tt + 2 rows with the halo, tt sized for ~16 KB of x) come
//   in through a two-slot ring of 16-byte cp.async.cg copies, zero-filled
//   outside [0, t_in) and beyond C_in, with the tile's batch row of mu and
//   inv, so the next tile's loads are in flight while this one computes.
//   Rows whose byte width is not a multiple of 16 (C_in % 8 != 0), or an x
//   that is not 16-byte aligned, are staged by plain 2-byte loads in the
//   same kernel.
// - phi is applied once per element, in place, from the staged tile: in
//   f32, then rounded to bf16, as the plain version and the JAX kernel
//   round it before their products. Rows outside [0, t_in) stay zero AFTER
//   phi (gelu(-mu inv) != 0). This pass, not the bytes, sets the time of
//   the fused calls (PERF.md).
// - Staged rows have a pitch of 16 x an odd number of bytes, so each
//   8-address phase of ldmatrix hits 8 distinct 16-byte bank groups.
// - Epilogue: bias added in f32, rounded to bf16 once, staged in shared
//   memory, written to y in 16-byte vectors; K2 reduces the staged (stored)
//   tile.
//
// f32 design (conv_k3_f32_kernel): CUDA cores and exact fmaf. The tensor
// cores would take f32 through TF32, from an exact result (max |d| 0 against
// the plain version) to ~1e-3, past the f32 checks; on the CUDA cores the
// f32 shapes with C_in and C_out of 32 or more at stride 1, and of 64 or
// more at stride 2, are bound by the FMA rate (67 TFLOP/s, ~20 FLOPs a
// byte). So the design keeps the FMA pipes fed:
// - Each thread holds an 8 x 8 register tile (8 consecutive times x 8
//   channels, two runs of 4), 192 FMAs per input channel from 3-5 float4
//   reads of x and 6 of w in shared memory.
// - A block covers 128 (C_out 128) to 512 (C_out 16, 32) output times, so w
//   is read from L2 once per 128-512 times, 2-4x less often than by the
//   4 x 4 loop this design replaced.
// - Input channels come through a two-slot ring in chunks of 8: x transposed
//   to [channel][time] (a thread's times are one float4 read) and w, by
//   4-byte cp.async copies with zero fill outside [0, t_in) and past C_in,
//   in flight while the previous chunk computes; phi applied once per
//   element in the slot.
//
// Measured with chip_smoke.py and bench_conv on an NVIDIA H100 80GB HBM3 at
// 700 W, B=8, as runs of 10 back-to-back calls (one call per CUDA-event pair
// adds the host's ~40 us a call): bf16 16->16 s1 over 1,228,800 times, phi
// the identity, 0.271 ms (69% of its 0.188 ms bytes bound; F.conv1d 3.20
// ms), with norm + gelu 0.669 ms (28%); 128->128 s1 over 19,200 times 0.108
// ms (22% of 0.024 ms), with norm + gelu 0.171 ms. One flagship forward's 80
// bf16 calls take ~10 ms of device time against a 3.0 ms bound. f32
// 128->128 s1 0.503 ms (45% of its 0.225 ms FMA bound; the 4 x 4 loop with
// w staged per 32 times before it: 0.755; F.conv1d without TF32: 0.635),
// 16->16 s1 0.669 ms (56% of 0.376 ms, bytes); no f32 shape is slower than
// F.conv1d. Per shape: PERF.md.
//
// Plain C interface, loaded with ctypes; see ops/conv_k3.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

enum Act { kLinear = 0, kGelu = 1, kRelu = 2, kLeaky = 3, kSilu = 4 };

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kGelu: return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
    case kRelu: return fmaxf(v, 0.0f);
    case kLeaky: return v >= 0.0f ? v : 0.01f * v;
    case kSilu: return v / (1.0f + expf(-v));
    default: return v;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; bytes past
// src_bytes (all 16 when 0) are zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes, zero-filled when src_bytes is 0.
__device__ __forceinline__ void cp_async4z(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------- f32 ----

constexpr int kChunk = 8;  // input channels staged per ring slot
constexpr int kTimes = 8;  // consecutive output times per thread
constexpr int kChans = 8;  // output channels per thread: two runs of 4

// Thread layout of the f32 kernel: CO / kChans channel groups x kGroupsT
// time groups; a tile is kGroupsT * kTimes output times (128 at C_out 128,
// 256 at 64, 512 at 32 and 16).
template <int CO>
struct F32Tiling {
  static constexpr int kGroupsC = CO / kChans;
  static constexpr int kGroupsT = CO == 16 ? 64 : 2048 / CO;
  static constexpr int kThreads = kGroupsC * kGroupsT;  // 256, or 128 at C_out 16
  static constexpr int kTile = kGroupsT * kTimes;
};

template <int CO>
constexpr int f32_tile() { return F32Tiling<CO>::kTile; }

// Staged x of one slot is [kChunk][pitch] (channel-major: a thread's
// consecutive times are consecutive floats, read as float4); the window's
// S * tile + 2 rows, and room for the float4 reads past them. pitch = 4
// (mod 32) words, so the 8 channels of a staging store hit 8 bank groups.
template <int CO, int S>
__host__ __device__ constexpr int f32_pitch() { return S * F32Tiling<CO>::kTile + 4; }

// Floats of one ring slot: x [kChunk][pitch], then w [kChunk][3][CO].
template <int CO, int S>
__host__ __device__ constexpr int f32_slot() { return kChunk * f32_pitch<CO, S>() + kChunk * 3 * CO; }

__device__ __forceinline__ float lane4(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// One block: one batch row, kTile consecutive output times, all CO channels.
// Input channels go through a two-slot ring in chunks of kChunk: x (zero
// outside [0, t_in) and beyond c_in) and w come in by 4-byte cp.async copies,
// transposed into the slot, while the previous chunk computes; phi, when
// fused, is applied once per element in the slot. With STATS, part[0] and
// part[1] ([batch, CO, gridDim.x] each) receive the tile's per-channel mean
// and M2 of the outputs.
template <int CO, int S, bool STATS>
__global__ void __launch_bounds__(F32Tiling<CO>::kThreads, 512 / F32Tiling<CO>::kThreads) conv_k3_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ mu, const float* __restrict__ inv, float* __restrict__ y,
    float* __restrict__ part, int t_in, int t_out, int c_in, int act) {
  using Tl = F32Tiling<CO>;
  constexpr int kThreads = Tl::kThreads, kTT = Tl::kTile;
  constexpr int kPitch = f32_pitch<CO, S>();
  constexpr int kSlot = f32_slot<CO, S>();
  constexpr int kRows = kTT * S + 2;          // staged window rows incl. halo
  constexpr int kVec = S == 1 ? 3 : 5;         // float4 reads of x a thread makes per channel
  extern __shared__ __align__(16) float smem_f32[];

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTT;
  const long in0 = (long)t0 * S - 1;  // input time of window row 0
  const int tid = threadIdx.x;
  const int tc = tid % Tl::kGroupsC, tt = tid / Tl::kGroupsC;
  const float* xb = x + (size_t)b * t_in * c_in;
  const bool fused = mu != nullptr;
  const int n_chunks = (c_in + kChunk - 1) / kChunk;

  auto load = [&](int chunk, int slot) {
    float* xs = smem_f32 + slot * kSlot;
    float* ws = xs + kChunk * kPitch;
    const int c0 = chunk * kChunk;
    for (int e = tid; e < kRows * kChunk; e += kThreads) {
      const int r = e / kChunk, c = e % kChunk, ch = c0 + c;
      const long t = in0 + r;
      const bool ok = t >= 0 && t < t_in && ch < c_in;
      cp_async4z(smem_u32(xs + c * kPitch + r), ok ? xb + (size_t)t * c_in + ch : x, ok ? 4 : 0);
    }
    // ws[(c * 3 + j) * CO + o] = w[j, c0 + c, o]
    for (int e = tid; e < kChunk * 3 * CO; e += kThreads) {
      const int o = e % CO, jc = e / CO, j = jc % 3, c = jc / 3, ch = c0 + c;
      const bool ok = ch < c_in;
      cp_async4z(smem_u32(ws + e), ok ? w + ((size_t)j * c_in + ch) * CO + o : w, ok ? 4 : 0);
    }
  };

  // phi in place on the slot's x, once per element; rows outside [0, t_in)
  // and channels past c_in stay zero.
  auto apply_phi = [&](int chunk, int slot) {
    float* xs = smem_f32 + slot * kSlot;
    const int c0 = chunk * kChunk;
    for (int e = tid; e < kRows * kChunk; e += kThreads) {
      const int c = e / kRows, r = e % kRows, ch = c0 + c;
      const long t = in0 + r;
      if (t < 0 || t >= t_in || ch >= c_in) continue;
      float& v = xs[c * kPitch + r];
      v = activate((v - mu[(size_t)b * c_in + ch]) * inv[(size_t)b * c_in + ch], act);
    }
  };

  float acc[kTimes][kChans];
#pragma unroll
  for (int i = 0; i < kTimes; ++i)
#pragma unroll
    for (int r = 0; r < kChans; ++r) acc[i][r] = 0.0f;

  load(0, 0);
  cp_async_commit();
  for (int k = 0; k < n_chunks; ++k) {
    if (k + 1 < n_chunks) load(k + 1, (k + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: chunk k has landed
    __syncthreads();
    if (fused) {
      apply_phi(k, k & 1);
      __syncthreads();
    }
    const float* xs = smem_f32 + (k & 1) * kSlot;
    const float* ws = xs + kChunk * kPitch;
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      float4 xv[kVec];
#pragma unroll
      for (int q = 0; q < kVec; ++q)
        xv[q] = *reinterpret_cast<const float4*>(xs + c * kPitch + tt * kTimes * S + 4 * q);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float* wr = ws + (c * 3 + j) * CO + tc * 4;
        const float4 wa = *reinterpret_cast<const float4*>(wr);
        const float4 wb = *reinterpret_cast<const float4*>(wr + CO / 2);
#pragma unroll
        for (int i = 0; i < kTimes; ++i) {
          const int m = i * S + j;
          const float v = lane4(xv[m / 4], m % 4);
          acc[i][0] = fmaf(wa.x, v, acc[i][0]);
          acc[i][1] = fmaf(wa.y, v, acc[i][1]);
          acc[i][2] = fmaf(wa.z, v, acc[i][2]);
          acc[i][3] = fmaf(wa.w, v, acc[i][3]);
          acc[i][4] = fmaf(wb.x, v, acc[i][4]);
          acc[i][5] = fmaf(wb.y, v, acc[i][5]);
          acc[i][6] = fmaf(wb.z, v, acc[i][6]);
          acc[i][7] = fmaf(wb.w, v, acc[i][7]);
        }
      }
    }
    __syncthreads();  // the slot is free for the load two chunks on
  }

  // Output channel of accumulator column r.
  auto chan = [&](int r) { return r < 4 ? tc * 4 + r : CO / 2 + tc * 4 + (r - 4); };
#pragma unroll
  for (int r = 0; r < kChans; ++r) {
    const float bv = bias ? bias[chan(r)] : 0.0f;
#pragma unroll
    for (int i = 0; i < kTimes; ++i) acc[i][r] += bv;
  }
#pragma unroll
  for (int i = 0; i < kTimes; ++i) {
    const int t = t0 + tt * kTimes + i;
    if (t >= t_out) continue;
    float* yp = y + ((size_t)b * t_out + t) * CO;
    *reinterpret_cast<float4*>(yp + tc * 4) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(yp + CO / 2 + tc * 4) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }

  if constexpr (STATS) {
    // Per-channel sum over the tile, then M2 about the tile's mean: each
    // thread reduces its kTimes outputs, shared memory the kGroupsT threads
    // of a channel group, in a fixed order. The ring's slots are free now.
    float* red = smem_f32;                    // [kGroupsT][CO]
    float* tmean = red + Tl::kGroupsT * CO;  // [CO]
    const int n_valid = min(kTT, t_out - t0);
    const int t_first = t0 + tt * kTimes;
#pragma unroll
    for (int r = 0; r < kChans; ++r) {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < kTimes; ++i) s += t_first + i < t_out ? acc[i][r] : 0.0f;
      red[tt * CO + chan(r)] = s;
    }
    __syncthreads();
    if (tid < CO) {
      float s = 0.0f;
      for (int g = 0; g < Tl::kGroupsT; ++g) s += red[g * CO + tid];
      tmean[tid] = s / (float)n_valid;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kChans; ++r) {
      const float m = tmean[chan(r)];
      float q = 0.0f;
#pragma unroll
      for (int i = 0; i < kTimes; ++i) {
        const float d = acc[i][r] - m;
        q += t_first + i < t_out ? d * d : 0.0f;
      }
      red[tt * CO + chan(r)] = q;
    }
    __syncthreads();
    if (tid < CO) {
      float q = 0.0f;
      for (int g = 0; g < Tl::kGroupsT; ++g) q += red[g * CO + tid];
      const size_t o = ((size_t)b * CO + tid) * gridDim.x + blockIdx.x;
      const size_t plane = (size_t)gridDim.y * CO * gridDim.x;
      part[o] = tmean[tid];
      part[plane + o] = q;
    }
  }
}

// --------------------------------------------------------------- bf16 ----

using bf16 = __nv_bfloat16;

// sm_90's opt-in limit of dynamic shared memory per block.
constexpr size_t kMaxSmem = 232448;
// Bytes of x one ring slot is sized to bring in (S * tt * C_in * 2).
constexpr int kStageBytes = 16384;

// Warp layout of one pass over kPass output times: kWarpsM x kWarpsN warps
// of kBlock threads, each with kMT m16 tiles x kNT n8 tiles of
// accumulators. A tile is a whole number of passes.
template <int CO>
struct Tiling {
  static constexpr int kBlock = CO == 128 ? 512 : 256;
  static constexpr int kWarpsN = CO >= 64 ? CO / 32 : 1;
  static constexpr int kWarpCols = CO / kWarpsN;  // 16 or 32
  static constexpr int kNT = kWarpCols / 8;
  static constexpr int kWarpsM = kBlock / 32 / kWarpsN;
  static constexpr int kMT = CO == 64 ? 2 : 1;
  static constexpr int kPass = kWarpsM * kMT * 16;  // 128, 128, 128, 64
  static constexpr int kOutPitch = CO + 8;           // staged y row, bf16
};

// Shared memory of the bf16 kernel: weights [3][CO][pitch], two x slots
// of S * tt + 2 rows, the y tile, then f32 bias, two (mu, inv) slots, a
// reduction buffer and the tile means. pitch = C_in rounded up to 16, plus
// 8: 16 x an odd number of bytes.
template <int CO>
size_t bf16_smem(int c_in, int stride, int tt) {
  const size_t cip = (c_in + 15) & ~15;
  return 2 * (3 * (size_t)CO + 2 * ((size_t)stride * tt + 2)) * (cip + 8) + 2 * (size_t)tt * Tiling<CO>::kOutPitch +
         4 * (2 * (size_t)CO + 4 * cip + Tiling<CO>::kBlock);
}

// Output times per tile (the statistics tile): as many passes as bring in
// about kStageBytes of x per slot, fewer if shared memory does not hold
// them; 0 if one pass does not fit.
template <int CO>
int bf16_tile(int c_in, int stride) {
  constexpr int pass = Tiling<CO>::kPass;
  int n = kStageBytes / (2 * stride * c_in * pass);
  for (n = n < 1 ? 1 : n; n > 0; --n)
    if (bf16_smem<CO>(c_in, stride, n * pass) <= kMaxSmem) break;
  return n * pass;
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

// Staged row of window row r (input time S * t0 - 1 + r): at stride 2 the
// even rows come first (tt + 1 of them), then the odd ones.
template <int S>
__device__ __forceinline__ int slot_row(int r, int tt) {
  return S == 1 ? r : (r & 1) ? tt + 1 + (r >> 1) : r >> 1;
}

// Persistent: block k walks items blockIdx.x + k * gridDim.x, item =
// b * n_tiles + tile, through a ring of two slots. With STATS, part[0] and
// part[1] ([batch, CO, n_tiles] each) receive each tile's per-channel mean
// and M2 of y as stored.
template <int CO, int S, bool STATS>
__global__ void __launch_bounds__(Tiling<CO>::kBlock, 512 / Tiling<CO>::kBlock) conv_k3_mma_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w, const bf16* __restrict__ bias,
    const float* __restrict__ mu, const float* __restrict__ inv, bf16* __restrict__ y,
    float* __restrict__ part, int batch, int t_in, int t_out, int c_in, int act, int tt, int vec) {
  using Tl = Tiling<CO>;
  constexpr int kThreads = Tl::kBlock;
  constexpr int OP = Tl::kOutPitch;
  const int cip = (c_in + 15) & ~15;
  const int pitch = cip + 8;  // bf16 elements per staged row
  const uint32_t pitch_b = 2 * pitch;
  const int chunks = cip / 8;  // 16-byte chunks per staged row
  const int rows = S * tt + 2;
  const int n_tiles = (t_out + tt - 1) / tt;
  const int n_items = batch * n_tiles;
  const bool fused = mu != nullptr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);
  bf16* slots = ws + 3 * CO * pitch;
  bf16* ys = slots + 2 * rows * pitch;
  float* bias_s = reinterpret_cast<float*>(ys + tt * OP);
  float* norm_s = bias_s + CO;  // [slot][mu, inv][cip]
  float* red = norm_s + 4 * cip;
  float* tmean = red + kThreads;

  // Window rows of item (zero outside [0, t_in) and beyond c_in), and its
  // batch row's mu and inv, into slot.
  auto load = [&](int item, int slot) {
    const int b = item / n_tiles;
    const long r0 = (long)(item - b * n_tiles) * tt * S - 1;
    const bf16* xb = x + (size_t)b * t_in * c_in;
    bf16* dst = slots + slot * rows * pitch;
    if (vec) {
      for (int q = tid; q < rows * chunks; q += kThreads) {
        const int r = q / chunks, cc = q - r * chunks;
        const long t = r0 + r;
        const bool ok = t >= 0 && t < t_in && cc * 8 < c_in;
        cp_async16(smem_u32(dst + slot_row<S>(r, tt) * pitch + cc * 8), ok ? xb + t * c_in + cc * 8 : x,
                   ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < rows * cip; e += kThreads) {
        const int r = e / cip, c = e - r * cip;
        const long t = r0 + r;
        dst[slot_row<S>(r, tt) * pitch + c] =
            t >= 0 && t < t_in && c < c_in ? xb[t * c_in + c] : __float2bfloat16(0.0f);
      }
    }
    if (fused) {
      float* norm_dst = norm_s + 2 * slot * cip;
      for (int c = tid; c < c_in; c += kThreads) {
        cp_async4(smem_u32(norm_dst + c), mu + (size_t)b * c_in + c);
        cp_async4(smem_u32(norm_dst + cip + c), inv + (size_t)b * c_in + c);
      }
    }
  };

  // phi in place on item's slot, once per element, rounded to bf16; rows
  // outside [0, t_in) and channels past c_in stay zero.
  auto apply_phi = [&](int item, int slot) {
    const long r0 = (long)(item % n_tiles) * tt * S - 1;
    bf16* xs = slots + slot * rows * pitch;
    const float* mu_s = norm_s + 2 * slot * cip;
    const float* inv_s = mu_s + cip;
    for (int q = tid; q < rows * chunks; q += kThreads) {
      const int s = q / chunks, cc = q - s * chunks;
      const int r = S == 1 ? s : s <= tt ? 2 * s : 2 * (s - tt - 1) + 1;
      const long t = r0 + r;
      if (t < 0 || t >= t_in || cc * 8 >= c_in) continue;
      uint4* p = reinterpret_cast<uint4*>(xs + s * pitch + cc * 8);
      uint4 v = *p;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = cc * 8 + 2 * i;
        float2 f = __bfloat1622float2(h[i]);
        f.x = c < c_in ? activate((f.x - mu_s[c]) * inv_s[c], act) : 0.0f;
        f.y = c + 1 < c_in ? activate((f.y - mu_s[c + 1]) * inv_s[c + 1], act) : 0.0f;
        h[i] = __floats2bfloat162_rn(f.x, f.y);
      }
      *p = v;
    }
  };

  // The ring: item k + 1 is in flight while item k computes.
  load(blockIdx.x, 0);
  cp_async_commit();
  // Weights as ws[(j * CO + o) * pitch + c] = w[j, c, o], zero for c >= c_in.
  for (int e = tid; e < 3 * CO * cip; e += kThreads) {
    const int o = e % CO, c = (e / CO) % cip, j = e / (CO * cip);
    ws[(j * CO + o) * pitch + c] = c < c_in ? w[((size_t)j * c_in + c) * CO + o] : __float2bfloat16(0.0f);
  }
  for (int o = tid; o < CO; o += kThreads) bias_s[o] = bias ? __bfloat162float(bias[o]) : 0.0f;

  const int wm = warp / Tl::kWarpsN, wn = warp % Tl::kWarpsN;
  const int n0 = wn * Tl::kWarpCols;
  // ldmatrix lane addresses: A rows (lane & 15) at k offset (lane >> 4) * 8;
  // B (two n8 tiles per x4) rows n0 + (lane & 7) + (lane >> 4) * 8 at k
  // offset ((lane >> 3) & 1) * 8.
  const uint32_t a_lane = (wm * Tl::kMT * 16 + (lane & 15)) * pitch_b + (lane >> 4) * 16;
  const uint32_t b_lane = (n0 + (lane & 7) + ((lane >> 4) << 3)) * pitch_b + ((lane >> 3) & 1) * 16;
  const int g = lane >> 2, tq = lane & 3;  // accumulator row and column pair

  for (int k = 0, item = blockIdx.x; item < n_items; ++k, item += gridDim.x) {
    if (item + (int)gridDim.x < n_items) load(item + gridDim.x, (k + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: item k has landed
    __syncthreads();
    if (fused) {
      apply_phi(item, k & 1);
      __syncthreads();
    }
    const int b = item / n_tiles, tile = item - b * n_tiles, t0 = tile * tt;

    const uint32_t xs_a = smem_u32(slots + (k & 1) * rows * pitch), ws_a = smem_u32(ws);
    for (int p0 = 0; p0 < tt; p0 += Tl::kPass) {
      float acc[Tl::kMT][Tl::kNT][4] = {};
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        // Staged row of output p0 + i's tap j is tap_row + p0 + i.
        const int tap_row = S == 1 ? j : j == 1 ? tt + 1 : j / 2;
        const uint32_t a_tap = xs_a + (tap_row + p0) * pitch_b + a_lane;
        const uint32_t b_tap = ws_a + j * CO * pitch_b + b_lane;
        for (int kk = 0; kk < cip / 16; ++kk) {
          uint32_t bf[Tl::kNT / 2][4];
#pragma unroll
          for (int np = 0; np < Tl::kNT / 2; ++np) ldmatrix_x4(bf[np], b_tap + np * 16 * pitch_b + kk * 32);
#pragma unroll
          for (int mi = 0; mi < Tl::kMT; ++mi) {
            uint32_t af[4];
            ldmatrix_x4(af, a_tap + mi * 16 * pitch_b + kk * 32);
#pragma unroll
            for (int ni = 0; ni < Tl::kNT; ++ni)
              mma_bf16(acc[mi][ni], af, bf[ni / 2][2 * (ni & 1)], bf[ni / 2][2 * (ni & 1) + 1]);
          }
        }
      }
      // Bias in f32, one rounding to bf16, into the staged y tile.
#pragma unroll
      for (int mi = 0; mi < Tl::kMT; ++mi) {
        const int row = p0 + wm * Tl::kMT * 16 + mi * 16 + g;
#pragma unroll
        for (int ni = 0; ni < Tl::kNT; ++ni) {
          const int col = n0 + ni * 8 + 2 * tq;
          const float b0 = bias_s[col], b1 = bias_s[col + 1];
          *reinterpret_cast<__nv_bfloat162*>(ys + row * OP + col) =
              __floats2bfloat162_rn(acc[mi][ni][0] + b0, acc[mi][ni][1] + b1);
          *reinterpret_cast<__nv_bfloat162*>(ys + (row + 8) * OP + col) =
              __floats2bfloat162_rn(acc[mi][ni][2] + b0, acc[mi][ni][3] + b1);
        }
      }
    }
    __syncthreads();

    // The tile's rows are contiguous in y: 16-byte stores.
    const int n_valid = min(tt, t_out - t0);
    constexpr int kRowChunks = CO / 8;
    bf16* yb = y + ((size_t)b * t_out + t0) * CO;
    for (int q = tid; q < n_valid * kRowChunks; q += kThreads) {
      const int r = q / kRowChunks, cc = q % kRowChunks;
      *reinterpret_cast<uint4*>(yb + (size_t)q * 8) = *reinterpret_cast<const uint4*>(ys + r * OP + cc * 8);
    }

    if constexpr (STATS) {
      // Sum, then M2 about the tile's mean, of the stored values: thread
      // (rg, c) takes rows rg, rg + kGroups, ...; then the kGroups partials
      // of a channel in order.
      constexpr int kGroups = kThreads / CO;
      const int c = tid % CO, rg = tid / CO;
      float s = 0.0f;
      for (int r = rg; r < n_valid; r += kGroups) s += __bfloat162float(ys[r * OP + c]);
      red[rg * CO + c] = s;
      __syncthreads();
      if (tid < CO) {
        float m = 0.0f;
        for (int i = 0; i < kGroups; ++i) m += red[i * CO + tid];
        tmean[tid] = m / (float)n_valid;
      }
      __syncthreads();
      const float m = tmean[c];
      float q2 = 0.0f;
      for (int r = rg; r < n_valid; r += kGroups) {
        const float d = __bfloat162float(ys[r * OP + c]) - m;
        q2 += d * d;
      }
      red[rg * CO + c] = q2;
      __syncthreads();
      if (tid < CO) {
        float m2 = 0.0f;
        for (int i = 0; i < kGroups; ++i) m2 += red[i * CO + tid];
        const size_t o = ((size_t)b * CO + tid) * n_tiles + tile;
        part[o] = tmean[tid];
        part[(size_t)batch * CO * n_tiles + o] = m2;
      }
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------- K2 merge ----

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

// ------------------------------------------------------------ launch ----

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

int merge(const Args& a, int c_out, int n_tiles, int tile) {
  merge_stats_kernel<<<a.batch * c_out, kMergeThreads, 0, a.stream>>>(
      a.part, a.mu_out, a.inv_out, a.batch * c_out, n_tiles, tile, a.t_out, a.eps);
  return static_cast<int>(cudaGetLastError());
}

template <int CO, int S, bool STATS>
int launch_f32(const Args& a) {
  constexpr int kTT = f32_tile<CO>();
  constexpr size_t kSmem = 2 * sizeof(float) * f32_slot<CO, S>();
  const auto kernel = conv_k3_f32_kernel<CO, S, STATS>;
  int rc = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem)));
  if (rc != 0) return rc;
  const dim3 grid((a.t_out + kTT - 1) / kTT, a.batch);
  kernel<<<grid, F32Tiling<CO>::kThreads, kSmem, a.stream>>>(
      static_cast<const float*>(a.x), static_cast<const float*>(a.w), static_cast<const float*>(a.bias), a.mu,
      a.inv, static_cast<float*>(a.y), a.part, a.t_in, a.t_out, a.c_in, a.act);
  rc = static_cast<int>(cudaGetLastError());
  return rc != 0 || !STATS ? rc : merge(a, CO, grid.x, kTT);
}

// Blocks of kernel resident on the current device with smem bytes of
// dynamic shared memory each, over all SMs.
int resident_blocks(const void* kernel, int threads, size_t smem, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0, rc = 0;
  if ((rc = static_cast<int>(cudaGetDevice(&dev))) != 0 ||
      (rc = static_cast<int>(
           cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kMaxSmem)))) != 0 ||
      (rc = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) != 0 ||
      (rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem))) != 0)
    return rc;
  *blocks = per_sm * sms;
  return 0;
}

template <int CO, int S, bool STATS>
int launch_bf16(const Args& a) {
  const int tt = bf16_tile<CO>(a.c_in, S);
  if (tt == 0 || reinterpret_cast<uintptr_t>(a.y) % 16 != 0) return -1;
  const long n_tiles = (a.t_out + tt - 1) / tt, items = a.batch * n_tiles;
  if (items >= (1L << 30)) return -1;  // item + gridDim.x stays an int
  const size_t smem = bf16_smem<CO>(a.c_in, S, tt);
  const auto kernel = conv_k3_mma_kernel<CO, S, STATS>;
  int resident = 0;
  int rc = resident_blocks(reinterpret_cast<const void*>(kernel), Tiling<CO>::kBlock, smem, &resident);
  if (rc != 0) return rc;
  if (resident < 1) return -1;
  const int grid = static_cast<int>(items < resident ? items : resident);
  const int vec = a.c_in % 8 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  kernel<<<grid, Tiling<CO>::kBlock, smem, a.stream>>>(
      static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.w), static_cast<const bf16*>(a.bias), a.mu, a.inv,
      static_cast<bf16*>(a.y), a.part, a.batch, a.t_in, a.t_out, a.c_in, a.act, tt, vec);
  rc = static_cast<int>(cudaGetLastError());
  return rc != 0 || !STATS ? rc : merge(a, CO, static_cast<int>(n_tiles), tt);
}

template <int S, bool STATS>
int dispatch_co(int dtype, int c_out, const Args& a) {
  switch (c_out) {
    case 16: return dtype == 0 ? launch_f32<16, S, STATS>(a) : launch_bf16<16, S, STATS>(a);
    case 32: return dtype == 0 ? launch_f32<32, S, STATS>(a) : launch_bf16<32, S, STATS>(a);
    case 64: return dtype == 0 ? launch_f32<64, S, STATS>(a) : launch_bf16<64, S, STATS>(a);
    case 128: return dtype == 0 ? launch_f32<128, S, STATS>(a) : launch_bf16<128, S, STATS>(a);
    default: return -1;
  }
}

template <bool STATS>
int dispatch(int dtype, int stride, int c_out, const Args& a) {
  if (a.batch <= 0 || a.batch > 65535 || a.t_in <= 0 || a.t_out <= 0 || a.c_in <= 0) return -1;
  if ((a.mu == nullptr) != (a.inv == nullptr) || (dtype != 0 && dtype != 1)) return -1;
  if (stride == 1) return dispatch_co<1, STATS>(dtype, c_out, a);
  if (stride == 2) return dispatch_co<2, STATS>(dtype, c_out, a);
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w, bias and y share it); mu/inv are
// float32 [batch, c_in] or both null; bias may be null; y 16-byte aligned.
// Returns 0 on success, -1 for an unsupported configuration, otherwise the
// CUDA error code of the launch.
extern "C" int w2s_conv_k3(const void* x, const void* w, const void* bias, const float* mu,
                           const float* inv, void* y, int batch, int t_in, int t_out, int c_in,
                           int c_out, int stride, int act, int dtype, void* stream) {
  const Args a{x, w, bias, mu, inv, y, nullptr, nullptr, nullptr,
               batch, t_in, t_out, c_in, act, 0.0f, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(dtype, stride, c_out, a);
}

// Output times per tile (K2's statistics tile) of a launch with these
// arguments; 0 if unsupported.
extern "C" int w2s_conv_k3_tile(int c_out, int c_in, int stride, int dtype) {
  if (c_in <= 0 || (stride != 1 && stride != 2)) return 0;
  if (dtype == 0) {
    switch (c_out) {
      case 16: return f32_tile<16>();
      case 32: return f32_tile<32>();
      case 64: return f32_tile<64>();
      case 128: return f32_tile<128>();
      default: return 0;
    }
  }
  if (dtype != 1) return 0;
  switch (c_out) {
    case 16: return bf16_tile<16>(c_in, stride);
    case 32: return bf16_tile<32>(c_in, stride);
    case 64: return bf16_tile<64>(c_in, stride);
    case 128: return bf16_tile<128>(c_in, stride);
    default: return 0;
  }
}

// K2: w2s_conv_k3 plus mu_out, inv_out (float32 [batch, c_out]) of y as
// stored; part is float32 scratch of 2 * batch * c_out * n_tiles, with
// n_tiles = ceil(t_out / w2s_conv_k3_tile(c_out, c_in, stride, dtype)).
extern "C" int w2s_conv_k3_stats(const void* x, const void* w, const void* bias, const float* mu,
                                 const float* inv, void* y, float* part, float* mu_out,
                                 float* inv_out, int batch, int t_in, int t_out, int c_in,
                                 int c_out, int stride, int act, int dtype, float eps,
                                 void* stream) {
  const Args a{x, w, bias, mu, inv, y, part, mu_out, inv_out,
               batch, t_in, t_out, c_in, act, eps, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(dtype, stride, c_out, a);
}
