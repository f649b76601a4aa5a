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
// bf16 design (conv_k3_wgmma_kernel): Hopper's warp-specialised loop of
// the K1 ladder's V7 (conv_variants_wgmma.cuh), generalised to K1's shapes.
// - Persistent blocks, one per SM, walk (batch, time-tile) items: two
//   producer warpgroups, one thread of which issues TMA (seven of their
//   warps apply phi), and two consumer warpgroups, each owning every other
//   stage of an even ring (up to 8 stages of ~8-36 KB of x), so one's
//   epilogue overlaps the other's products. setmaxnreg moves registers
//   from the producers (96) to the consumers (160).
// - Products: wgmma m64nCOk16 (C_out 16, 32, 64, 128 as N), A (phi(x)) and
//   B (w) from shared memory, f32 sums. A tile is 128 / C_out wgmma tiles of
//   64 rows (512, 256, 128, 64 outputs; fewer where C_in is wider than
//   C_out), 64 accumulators a thread at every width, so a narrow conv's
//   tile brings in as many bytes as a wide one's.
// - x through TMA with a 3-D map (C, T, B) in boxes of one batch row: a
//   tile never straddles two nights, and TMA zero-fills t = -1 and t >= T.
//   Boxes are wc = 16, 32 or 64 channels (C_in padded to 16: rows of 32, 64
//   or 128 bytes, with the swizzle of the same width; 128 input channels
//   are two boxes), each box of rows in its own atom-aligned region.
// - The taps: tap j's A descriptor starts j rows into a window of tile + 2
//   rows (stride 1); no tap copies or shifts anything. Stride 2 loads the
//   window's even and odd rows into two windows, so every tap still reads
//   consecutive rows: tap 1 the even window at row t - t0, taps 0 and 2 the
//   odd one (from 2 t0 - 1) at rows t - t0 and t - t0 + 1. The two windows
//   come from two maps of their own over x's rows 2q and 2q + 1 (the odd
//   one starting at row 1), each with its exact extent, so TMA's bounds
//   zero-fill both ends at either parity of T. Chosen over one map with a
//   traversal stride of 2: that box's extent counts the rows it skips, so
//   the 256-row limit of a box would halve, and every other TMA load here
//   and in the ladder keeps the element stride at 1.
// - The weights come in once per block by plain 16-byte loads, as
//   [tap][box][C_out][wc] (K-major B, zero past C_in): x's and w's boxes
//   then share one descriptor form and swizzle at every width, and a C_in
//   that is not a multiple of 16 gets its K padded with zero weights.
// - Rows TMA cannot address (C_in % 8 != 0, x not 16-byte aligned, or T 1
//   at stride 2) are staged by the producer warpgroups' 2-byte loads into
//   the same layout, in the same kernel; then no TMA load of x is made, so
//   no two asynchronous writes meet in a stage.
// - phi in place on a landed stage, once per element, by the seven producer
//   warps that do not issue TMA: in f32, rounded to bf16
//   as the plain version and the JAX kernel round it, on rows inside [0, T)
//   and channels below C_in only (the rest stay zero: gelu(-mu inv) != 0);
//   the async proxy is fenced and the stage handed to its consumer through
//   a third mbarrier (ready). So phi runs a stage or more ahead of the
//   products and off the consumers' path. phi is latency-bound per thread
//   (gelu's erff), so its rate follows its threads: on the consumers, with
//   the activation a run-time switch per element, and on three warps, the
//   fused 16-channel calls ran slower than the kernel before this one
//   (PERF.md). The plain-load producer applies phi as it stages.
// - Epilogue: bias in f32, one rounding to bf16, y staged with its map's
//   swizzle and stored by TMA (which drops rows past t_out), in one pass
//   over the accumulators. K2 reduces the tile's valid rows as stored
//   while the store runs, then merges its partials in order (Chan): at
//   C_out 16 and 32 from the registers (each warp's mean and M2 about it,
//   shuffles across the 8 lanes of a column); at 64 and 128, where a lane
//   holds 16 or 32 columns and those shuffles cost more than the rows,
//   from the staged tile (a column's rows in one of 128 / C_out row groups
//   a thread).
// - Offsets into x and the statistics are 64-bit (an EOG block-0 tensor
//   holds up to 1.26e9 elements); TMA takes the tensor's shape, not offsets.
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
// adds the host's time a call): the bf16 kernel before this design
// (mma.sync, cp.async) ran 16->16 s1 over 1,228,800 times, phi the
// identity, in 0.271 ms (69% of its 0.188 ms bytes bound), with norm + gelu
// 0.669 ms; 128->128 s1 over 19,200 times 0.108 ms (22% of 0.024 ms); its
// 80 calls of a flagship forward 11.4 ms against a 3.0 ms bound; this
// design's times are in PERF.md. f32
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
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

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

// 4 bytes, zero-filled when src_bytes is 0.
__device__ __forceinline__ void cp_async4z(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
constexpr int kConsumers = 2;                   // warpgroups that run the products
constexpr int kBlock = (kConsumers + 2) * 128;  // and two producer warpgroups
constexpr int kProducer = kConsumers * 128;     // their first thread, which issues TMA
constexpr int kPhiThreads = 7 * 32;             // the other producer warps but the first: phi
// Registers a thread after the split (setmaxnreg): the consumers hold 64
// accumulators and K2's statistics; 512 threads start at 128 each.
constexpr int kProducerRegs = 96, kConsumerRegs = 160;
static_assert(kConsumers * kConsumerRegs + (kBlock / 128 - kConsumers) * kProducerRegs == 65536 / 128,
              "the split hands the producers' registers to the consumers");
constexpr int kMaxStages = 8;
// Bytes of x a stage may hold before a tile's rows are halved (C_in wider
// than C_out): the 16 -> 16 stride-2 stage, 32.3 KB, and 128 -> 128's.
constexpr uint32_t kStageTarget = 36864;

// Per C_out: a tile is up to kSub wgmma tiles of 64 output rows, so that
// its f32 sums are 64 registers a consumer thread at every width (kSub x
// CO / 2), and a narrow conv's tile brings in as many bytes as a wide
// one's. Where C_in is wider than C_out, the geometry halves the rows
// (n_sub) until a stage holds at most kStageTarget bytes of x.
template <int CO>
struct Tile {
  static constexpr int kSub = 128 / CO;
  static constexpr int kRows = 64 * kSub;           // 512, 256, 128, 64 output times at most
  static constexpr int kYCols = CO < 64 ? CO : 64;  // channels of a y box: rows of 32, 64 or 128 bytes
  static constexpr int kYWidth = 2 * kYCols;
  static constexpr int kYBytes = kRows * CO * 2;    // one consumer's staged y tile, 16 KB
};

// One launch's shapes and shared-memory plan (bf16_geometry), passed by
// value. x's window of a tile at t0, per box of wc = width / 2 input
// channels: stride 1, input times t0 - 1 .. t0 + rows (rows + 2 of them);
// stride 2, the even times 2 t0 .. (rows) and then, win1 bytes on, the odd
// times 2 t0 - 1 .. (rows + 1); each window rounded up to whole 8-row
// swizzle atoms.
struct Geometry {
  int batch, t_in, t_out, c_in, act;
  int n_tiles, n_items;
  int rows;      // output times a tile: 64 n_sub
  int n_sub;     // wgmma tiles of 64 rows a tile (at most Tile<CO>::kSub)
  int box_rows;  // rows of a TMA box, min(rows, 256)
  int cp;        // C_in rounded up to 16: the products' K, zero-padded
  int width;     // bytes of a box row, 32, 64 or 128: the swizzle of x's and w's boxes
  int boxes;     // cp / wc
  int stages;    // of the ring (even)
  int tma;       // x comes in by TMA; else the producer warpgroups stage it by plain loads
  int w_vec;     // w is 16-byte aligned
  uint32_t win1;         // the odd window's offset in a box (stride 2)
  uint32_t box_bytes;    // a box's windows
  uint32_t stage_bytes;  // boxes x box_bytes, rounded up to 1 KB
  uint32_t tx_bytes;     // what TMA writes into a stage
  uint32_t ys_off, ws_off, f_off, bar_off;  // shared memory: y tiles, weights, floats, mbarriers
};

// The plan for C_in c_in: box width, windows, the deepest even ring (at
// most kMaxStages) that fits beside two y tiles, the weights, bias and the
// consumers' scratch; false if not even two stages fit.
template <int CO, int S>
bool bf16_geometry(int c_in, Geometry* g, size_t* smem) {
  using T = Tile<CO>;
  if (c_in < 1 || c_in > 128) return false;
  const int cp = (c_in + 15) & ~15;
  const int wc = cp % 64 == 0 ? 64 : cp % 32 == 0 ? 32 : 16;
  const auto atoms = [&](int rows) { return static_cast<uint32_t>((rows + 7) / 8 * 8 * 2 * wc); };
  g->cp = cp;
  g->width = 2 * wc;
  g->boxes = cp / wc;
  for (g->n_sub = T::kSub;; g->n_sub /= 2) {
    g->rows = 64 * g->n_sub;
    const int rows0 = S == 1 ? g->rows + 2 : g->rows, rows1 = S == 1 ? 0 : g->rows + 1;
    g->win1 = atoms(rows0);
    g->box_bytes = atoms(rows0) + (rows1 ? atoms(rows1) : 0);
    g->tx_bytes = static_cast<uint32_t>(g->boxes * 2 * wc * (rows0 + rows1));
    if (g->n_sub == 1 || g->boxes * g->box_bytes <= kStageTarget) break;
  }
  g->box_rows = g->rows < 256 ? g->rows : 256;
  g->stage_bytes = (g->boxes * g->box_bytes + 1023) / 1024 * 1024;
  // Floats: bias [CO]; the phi warps' mu and inv [2][128]; per consumer
  // K2's warps' means and M2s [8][CO].
  const uint32_t floats = 4 * (CO + 256 + kConsumers * 8 * CO);
  for (int stages = kMaxStages; stages >= 2; stages -= 2) {
    g->stages = stages;
    g->ys_off = stages * g->stage_bytes;
    g->ws_off = g->ys_off + kConsumers * T::kYBytes;
    g->f_off = g->ws_off + 3 * cp * CO * 2;
    g->bar_off = (g->f_off + floats + 7) / 8 * 8;
    *smem = 1024 /* alignment of the swizzled boxes */ + g->bar_off + 24 * stages;  // full, empty, ready
    if (*smem <= kMaxSmem) return true;
  }
  return false;
}

// x's maps (stride 1: the window's first `rows` rows in boxes of
// box_rows, its last 2; stride 2: the even rows, the odd rows, the last odd
// row) and y's map.
struct Maps {
  CUtensorMap x[3];
  CUtensorMap y;
};

// Byte offset of 16-byte chunk `chunk` of row r in a box of `width`-byte
// rows that starts on an atom: the swizzle TMA writes (hopper.cuh).
__device__ __forceinline__ uint32_t swizzled(int r, int chunk, int width) {
  return r * width + ((chunk ^ ((r * width >> 7) & (width / 16 - 1))) << 4);
}

// Input time of row r of window i (stride 2: 0 even, 1 odd) of the tile at t0.
template <int S>
__device__ __forceinline__ int window_time(int i, int r, int t0) {
  return S == 1 ? t0 - 1 + r : 2 * (t0 + r) - i;
}

// phi in place on one landed stage: in f32, rounded to bf16, on the rows
// inside [0, t_in) and the channels below c_in only; the rest stay the
// zeros TMA wrote (gelu(-mu inv) != 0). Thread ptid of n_threads takes the
// stage's 16-byte chunks ptid, ptid + n_threads, ..., two an iteration;
// c_in is a multiple of 8 (the TMA route), so a chunk is all in or all out.
// ACT is the activation (kLinear .. kSilu), a template argument, and every
// element is computed whether its chunk is stored or not: the two chunks'
// 16 elements are straight-line code the compiler interleaves. mu_s,
// inv_s: the tile's batch row, in shared memory.
template <int S, int ACT>
__device__ __forceinline__ void apply_phi(unsigned char* stage, const Geometry& g, int t0, const float* mu_s,
                                          const float* inv_s, int ptid, int n_threads) {
  const int width = g.width, wc = width / 2, cpr = width / 16, cpr_log = 31 - __clz(cpr);
  for (int i = 0; i < S; ++i) {
    const int rows = S == 1 ? g.rows + 2 : g.rows + i, total = rows * cpr;
    for (int box = 0; box < g.boxes; ++box) {
      unsigned char* region = stage + box * g.box_bytes + (i ? g.win1 : 0);
      for (int q0 = ptid; q0 < total; q0 += 2 * n_threads) {
        uint4 v[2];
        uint4* ptr[2];
        bool keep[2];
        float m[2][8], s[2][8];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int q = min(q0 + u * n_threads, total - 1);
          const int r = q >> cpr_log, p = q & (cpr - 1);
          const int t = window_time<S>(i, r, t0);
          const int c0 = box * wc + ((p ^ ((r * width >> 7) & (cpr - 1))) << 3);
          keep[u] = q0 + u * n_threads < total && t >= 0 && t < g.t_in && c0 < g.c_in;
          ptr[u] = reinterpret_cast<uint4*>(region + r * width + p * 16);
          v[u] = *ptr[u];
#pragma unroll
          for (int k = 0; k < 8; k += 4) {
            *reinterpret_cast<float4*>(&m[u][k]) = *reinterpret_cast<const float4*>(mu_s + c0 + k);
            *reinterpret_cast<float4*>(&s[u][k]) = *reinterpret_cast<const float4*>(inv_s + c0 + k);
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v[u]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h[e]);
            h[e] = __floats2bfloat162_rn(activate((f.x - m[u][2 * e]) * s[u][2 * e], ACT),
                                         activate((f.y - m[u][2 * e + 1]) * s[u][2 * e + 1], ACT));
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u)
          if (keep[u]) *ptr[u] = v[u];
      }
    }
  }
}

// Persistent, warp-specialised: block k walks items blockIdx.x + n
// gridDim.x (item = b n_tiles + tile), local item n through ring stage
// n % stages, which consumer warpgroup n % 2 owns. The producer
// warpgroups: one thread issues TMA; with phi fused the seven warps after
// the first apply phi to each landed stage and release it to its consumer
// through the stage's ready barrier. With STATS, part[0] and part[1]
// ([batch, CO, n_tiles] each) receive each tile's per-channel mean and M2
// of y as stored.
template <int CO, int S, bool STATS>
__global__ void __launch_bounds__(kBlock, 1) conv_k3_wgmma_kernel(
    const __grid_constant__ Maps maps, const bf16* __restrict__ x, const bf16* __restrict__ w,
    const bf16* __restrict__ bias, const float* __restrict__ mu, const float* __restrict__ inv,
    float* __restrict__ part, const Geometry g) {
  using T = Tile<CO>;
  const int TM = g.rows;
  // Each consumer warpgroup owns every other stage, so items n and n +
  // stages of a stage go to one warpgroup, in order: its wait on the full
  // barrier for item n + stages cannot come before item n's load has
  // landed, which a parity wait could not tell apart (ROADMAP C.3).
  static_assert(kMaxStages % kConsumers == 0, "each consumer warpgroup owns every other stage");
  static_assert(kPhiThreads == kBlock - kProducer - 32, "the phi warps are the producer warps but the first");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  const uint32_t ring = smem_u32(base), ys = ring + g.ys_off, ws = ring + g.ws_off;
  float* floats = reinterpret_cast<float*>(base + g.f_off);  // bias [CO], mu and inv [2][128], red [2][8][CO]
  const uint32_t full = ring + g.bar_off, empty = full + 8 * g.stages, ready = empty + 8 * g.stages;
  const int tid = threadIdx.x, wg = tid / 128;
  const int width = g.width, wc = width / 2, cpr_log = 31 - __clz(width / 16);
  const int wc_log = 31 - __clz(wc);
  const int n_items = g.n_items;
  const bool fused = mu != nullptr;

  if (tid == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128);
      mbar_init(ready + 8 * s, 1);
    }
    fence_mbar_init();
  }
  __syncthreads();

  // The producer thread's TMA loads of item's window into stage s.
  const auto issue = [&](int item, int s) {
    const int b = item / g.n_tiles, t0 = (item - b * g.n_tiles) * TM;
    const uint32_t st = ring + s * g.stage_bytes, bar = full + 8 * s;
    mbar_expect_tx(bar, g.tx_bytes);
    for (int box = 0; box < g.boxes; ++box) {
      const uint32_t r = st + box * g.box_bytes;
      const int c = box * wc;
      for (int m = 0; m < TM; m += g.box_rows)
        tma_load(r + m * width, &maps.x[0], bar, c, S == 1 ? t0 - 1 + m : t0 + m, b);
      if (S == 1) {
        tma_load(r + TM * width, &maps.x[1], bar, c, t0 - 1 + TM, b);
      } else {
        for (int m = 0; m < TM; m += g.box_rows) tma_load(r + g.win1 + m * width, &maps.x[1], bar, c, t0 - 1 + m, b);
        tma_load(r + g.win1 + TM * width, &maps.x[2], bar, c, t0 - 1 + TM, b);
      }
    }
  };

  // The first round finds every stage free: its loads go out before the
  // weights are staged.
  if (g.tma && tid == kProducer)
    for (int n = 0, item = blockIdx.x; n < g.stages && item < n_items; ++n, item += gridDim.x) issue(item, n);

  // Weights, once per block, K-major as wgmma's B: ws[j][box][o] is a row
  // of the box's wc input channels of output o (zero past c_in), swizzled
  // as x's boxes, so x and w share one descriptor form at every width.
  {
    unsigned char* wsp = base + g.ws_off;
    const auto put = [&](int j, int c, int o, bf16 v) {
      const int box = c >> wc_log, cc = c & (wc - 1);
      *reinterpret_cast<bf16*>(wsp + (j * g.boxes + box) * CO * width + swizzled(o, cc >> 3, width) + (cc & 7) * 2) = v;
    };
    if (g.w_vec) {
      for (int e = tid; e < 3 * g.cp * (CO / 8); e += kBlock) {
        const int o8 = (e % (CO / 8)) * 8, jc = e / (CO / 8), c = jc % g.cp, j = jc / g.cp;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (c < g.c_in) v = __ldg(reinterpret_cast<const uint4*>(w + ((size_t)j * g.c_in + c) * CO + o8));
        const bf16* h = reinterpret_cast<const bf16*>(&v);
#pragma unroll
        for (int q = 0; q < 8; ++q) put(j, c, o8 + q, h[q]);
      }
    } else {
      for (int e = tid; e < 3 * g.cp * CO; e += kBlock) {
        const int o = e % CO, jc = e / CO, c = jc % g.cp, j = jc / g.cp;
        put(j, c, o, c < g.c_in ? w[((size_t)j * g.c_in + c) * CO + o] : __float2bfloat16(0.0f));
      }
    }
    for (int o = tid; o < CO; o += kBlock) floats[o] = bias ? __bfloat162float(bias[o]) : 0.0f;
    fence_async_shared();
    __syncthreads();
  }

  if (wg >= kConsumers) {  // the producer warpgroups
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int ptid = tid - kProducer;
    if (!g.tma) {
      // Rows TMA cannot address (C_in % 8 != 0, x not 16-byte aligned, T 1
      // at stride 2): all 256 threads stage the windows by 2-byte loads
      // into the same swizzled layout, zero outside [0, t_in) and past
      // c_in, phi applied on the way.
      int s = 0, ph = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        mbar_wait(empty + 8 * s, ph ^ 1);  // the first round finds every stage free
        const int b = item / g.n_tiles, t0 = (item - b * g.n_tiles) * TM;
        const bf16* xb = x + (size_t)b * g.t_in * g.c_in;
        for (int i = 0; i < S; ++i) {
          const int rows = S == 1 ? TM + 2 : TM + i;
          for (int box = 0; box < g.boxes; ++box) {
            unsigned char* region = base + s * g.stage_bytes + box * g.box_bytes + (i ? g.win1 : 0);
            for (int e = ptid; e < rows * wc; e += kBlock - kProducer) {
              const int r = e >> wc_log, c = e & (wc - 1), ch = box * wc + c;
              const int t = window_time<S>(i, r, t0);
              bf16 v = __float2bfloat16(0.0f);
              if (t >= 0 && t < g.t_in && ch < g.c_in) {
                const size_t o = (size_t)t * g.c_in + ch;
                v = fused ? __float2bfloat16(activate((__bfloat162float(xb[o]) - mu[(size_t)b * g.c_in + ch]) *
                                                          inv[(size_t)b * g.c_in + ch],
                                                      g.act))
                          : xb[o];
              }
              *reinterpret_cast<bf16*>(region + swizzled(r, c >> 3, width) + (c & 7) * 2) = v;
            }
          }
        }
        fence_async_shared();
        named_bar_sync(3, kBlock - kProducer);
        if (ptid == 0) mbar_arrive(full + 8 * s);
        if (++s == g.stages) s = 0, ph ^= 1;
      }
    } else if (ptid == 0) {
      int s = 0, ph = 0;
      for (int n = 0, item = blockIdx.x; item < n_items; ++n, item += gridDim.x) {
        if (n >= g.stages) {
          mbar_wait(empty + 8 * s, ph ^ 1);
          issue(item, s);
        }
        if (++s == g.stages) s = 0, ph ^= 1;
      }
    } else if (fused && ptid >= 32) {
      // The phi warps (kPhiThreads): each landed stage in turn, a stage or
      // more ahead of the consumers, which wait on its ready barrier.
      float* mu_s = floats + CO;
      float* inv_s = mu_s + 128;
      const int qtid = ptid - 32;
      int s = 0, ph = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int b = item / g.n_tiles, t0 = (item - b * g.n_tiles) * TM;
        for (int c = qtid; c < g.c_in; c += kPhiThreads) {
          mu_s[c] = mu[(size_t)b * g.c_in + c];
          inv_s[c] = inv[(size_t)b * g.c_in + c];
        }
        named_bar_sync(3, kPhiThreads);
        mbar_wait(full + 8 * s, ph);
        unsigned char* stage = base + s * g.stage_bytes;
        switch (g.act) {
          case kGelu: apply_phi<S, kGelu>(stage, g, t0, mu_s, inv_s, qtid, kPhiThreads); break;
          case kRelu: apply_phi<S, kRelu>(stage, g, t0, mu_s, inv_s, qtid, kPhiThreads); break;
          case kLeaky: apply_phi<S, kLeaky>(stage, g, t0, mu_s, inv_s, qtid, kPhiThreads); break;
          case kSilu: apply_phi<S, kSilu>(stage, g, t0, mu_s, inv_s, qtid, kPhiThreads); break;
          default: apply_phi<S, kLinear>(stage, g, t0, mu_s, inv_s, qtid, kPhiThreads); break;
        }
        fence_async_shared();
        named_bar_sync(3, kPhiThreads);
        if (qtid == 0) mbar_arrive(ready + 8 * s);
        if (++s == g.stages) s = 0, ph ^= 1;
      }
    }
    return;
  }

  // The consumers: with phi applied by the phi warps, a stage is theirs
  // once its ready barrier has completed, else once its full one has.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const uint32_t landed = fused && g.tma ? ready : full;
  const int wtid = tid & 127, warp = wtid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int bar = 1 + wg;  // this warpgroup's named barrier
  const float* bias_s = floats;
  float* red = floats + CO + 256 + wg * 8 * CO;  // K2: partial means, then M2s: [4 warps][CO] or [G][CO]
  const uint32_t ybuf = ys + wg * T::kYBytes;
  const int kpb_log = cpr_log - 1;  // k-steps of 16 channels a box row: width / 32
  float acc[T::kSub][CO / 2] = {};
  int s = wg, ph = 0;
  for (int item = blockIdx.x + wg * gridDim.x; item < n_items; item += kConsumers * gridDim.x) {
    const int b = item / g.n_tiles, tile = item - b * g.n_tiles, t0 = tile * TM;
    mbar_wait(landed + 8 * s, ph);
    const uint32_t st = ring + s * g.stage_bytes;

    // Three taps x cp / 16 k-steps x n_sub row tiles. Tap j of output row i
    // reads window row i + j (stride 1); at stride 2 tap 1 the even window's
    // row i, taps 0 and 2 the odd window's rows i and i + 1: each tap's
    // descriptor starts that many rows into its window, so no tap copies.
    // ALL: every wgmma tile of the tile is in use (n_sub = kSub, C_in <=
    // C_out), so the products issue with no branch between them.
    const auto products = [&](auto all) {
      for (int kk = 0; kk < g.cp / 16; ++kk) {
        const int box = kk >> kpb_log;
        const uint32_t step = (kk & ((1 << kpb_log) - 1)) * 32;  // the k-step's 32 bytes in the box row
        const uint32_t a = st + box * g.box_bytes + step;
        const uint32_t bw = ws + box * CO * width + step;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const uint64_t desc_b = smem_desc(bw + j * g.boxes * CO * width, width);
          const uint32_t aj = S == 1 ? a + j * width : j == 1 ? a : a + g.win1 + (j / 2) * width;
#pragma unroll
          for (int sub = 0; sub < T::kSub; ++sub)
            if (decltype(all)::value || sub < g.n_sub)
              wgmma<0>(acc[sub], smem_desc(aj + sub * 64 * width, width), desc_b, kk > 0 || j > 0);
        }
      }
    };
    wgmma_fence();
    if (g.n_sub == T::kSub)
      products(std::true_type{});
    else
      products(std::false_type{});
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int sub = 0; sub < T::kSub; ++sub) fence_operands(acc[sub]);
    mbar_arrive(empty + 8 * s);
    if ((s += kConsumers) >= g.stages) s -= g.stages, ph ^= 1;

    // Bias in f32 and one rounding to bf16, straight into the staged y
    // tile with the y map's swizzle (conflict-free), once this warpgroup's
    // last TMA store has read it; acc keeps y as stored for K2. Then one
    // thread stores the tile; TMA drops the rows past t_out.
    const int n_valid = min(TM, g.t_out - t0);
    if (wtid == 0) bulk_wait_read();
    named_bar_sync(bar, 128);
#pragma unroll
    for (int i = 0; i < CO / 8; ++i) {
      const int col = 8 * i + 2 * tq, yb = col / T::kYCols, cc = col % T::kYCols;
      const float b0 = bias_s[col], b1 = bias_s[col + 1];
#pragma unroll
      for (int sub = 0; sub < T::kSub; ++sub)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (sub >= g.n_sub) continue;
          const int r = sub * 64 + warp * 16 + gq + 8 * h;
          const uint32_t pair = pack_bf16x2(acc[sub][4 * i + 2 * h] + b0, acc[sub][4 * i + 2 * h + 1] + b1);
          const uint32_t addr = ybuf + yb * T::kRows * T::kYWidth + swizzled(r, cc >> 3, T::kYWidth) + (cc & 7) * 2;
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(pair) : "memory");
          if constexpr (STATS && CO <= 32) {
            const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pair));
            acc[sub][4 * i + 2 * h] = f.x;
            acc[sub][4 * i + 2 * h + 1] = f.y;
          }
        }
    }
    fence_async_shared();
    named_bar_sync(bar, 128);
    if (wtid == 0) {
#pragma unroll
      for (int yb = 0; yb < CO / T::kYCols; ++yb)
        for (int m = 0; m < TM; m += g.box_rows)
          tma_store(&maps.y, ybuf + yb * T::kRows * T::kYWidth + m * T::kYWidth, yb * T::kYCols, t0 + m, b);
      bulk_commit();
    }

    if constexpr (STATS && CO <= 32) {
      // Per channel over the tile's valid rows as stored, while the TMA
      // store runs, from the registers: each warp's mean and M2 about it
      // over its rows (the lane's rows, then shuffles over the 8 lanes of a
      // column, all CO / 4 columns a lane holds side by side so that their
      // chains interleave), then the 4 warps merged in order (Chan).
      constexpr int NC = CO / 4;  // columns a lane holds: 8 (k / 2) + 2 tq + k % 2
      bool valid[T::kSub][2];
      int n_warp = 0;  // valid rows of this warp: 16 of each 64-row tile
#pragma unroll
      for (int sub = 0; sub < T::kSub; ++sub) {
        n_warp += max(0, min(16, n_valid - sub * 64 - warp * 16));
#pragma unroll
        for (int h = 0; h < 2; ++h) valid[sub][h] = sub * 64 + warp * 16 + gq + 8 * h < n_valid;
      }
      const float inv_n = n_warp ? 1.0f / n_warp : 0.0f;
      float mean[NC], m2[NC];
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        mean[k] = 0.0f;
#pragma unroll
        for (int sub = 0; sub < T::kSub; ++sub)
#pragma unroll
          for (int h = 0; h < 2; ++h) mean[k] += valid[sub][h] ? acc[sub][4 * (k / 2) + 2 * h + k % 2] : 0.0f;
      }
#pragma unroll
      for (int lanes = 4; lanes < 32; lanes *= 2)
#pragma unroll
        for (int k = 0; k < NC; ++k) mean[k] += __shfl_xor_sync(0xffffffffu, mean[k], lanes);
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        mean[k] *= inv_n;
        m2[k] = 0.0f;
#pragma unroll
        for (int sub = 0; sub < T::kSub; ++sub)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float d = acc[sub][4 * (k / 2) + 2 * h + k % 2] - mean[k];
            m2[k] += valid[sub][h] ? d * d : 0.0f;
          }
      }
#pragma unroll
      for (int lanes = 4; lanes < 32; lanes *= 2)
#pragma unroll
        for (int k = 0; k < NC; ++k) m2[k] += __shfl_xor_sync(0xffffffffu, m2[k], lanes);
      if (gq == 0)
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          const int col = 8 * (k / 2) + 2 * tq + k % 2;
          red[warp * CO + col] = mean[k];
          red[(4 + warp) * CO + col] = m2[k];
        }
      named_bar_sync(bar, 128);
      if (wtid < CO) {
        float n = 0.0f, mu_t = 0.0f, m2_t = 0.0f;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          int n_v = 0;
#pragma unroll
          for (int sub = 0; sub < T::kSub; ++sub) n_v += max(0, min(16, n_valid - sub * 64 - v * 16));
          chan_merge(n, mu_t, m2_t, (float)n_v, red[v * CO + wtid], red[(4 + v) * CO + wtid]);
        }
        const size_t o = ((size_t)b * CO + wtid) * g.n_tiles + tile;
        part[o] = mu_t;
        part[(size_t)g.batch * CO * g.n_tiles + o] = m2_t;
      }
    } else if constexpr (STATS) {
      // C_out 64 and 128, where a lane holds 16 or 32 columns and the
      // shuffles above cost more than the rows: read the staged tile back
      // while the TMA store reads it too. Thread (rg, c) takes column c's
      // rows rg, rg + G, ... (G = 128 / CO row groups), their mean, then
      // M2 about it; column c's G partials are merged in order (Chan). The
      // next tile's staging waits at its named barrier until every thread
      // is past these reads.
      constexpr int G = 128 / CO;
      const int c = wtid % CO, rg = wtid / CO, cc = c % T::kYCols;
      const unsigned char* col = base + (ybuf - ring) + c / T::kYCols * T::kRows * T::kYWidth + (cc & 7) * 2;
      const auto y_at = [&](int r) {
        return __bfloat162float(*reinterpret_cast<const bf16*>(col + swizzled(r, cc >> 3, T::kYWidth)));
      };
      const int n_rows = rg < n_valid ? (n_valid - rg + G - 1) / G : 0;
      float sum = 0.0f;
#pragma unroll 8
      for (int k = 0; k < n_rows; ++k) sum += y_at(rg + G * k);
      const float mean = n_rows ? sum / n_rows : 0.0f;
      float m2 = 0.0f;
#pragma unroll 8
      for (int k = 0; k < n_rows; ++k) {
        const float d = y_at(rg + G * k) - mean;
        m2 += d * d;
      }
      red[rg * CO + c] = mean;
      red[G * CO + rg * CO + c] = m2;
      named_bar_sync(bar, 128);
      if (wtid < CO) {
        float n = 0.0f, mu_t = 0.0f, m2_t = 0.0f;
        for (int v = 0; v < G; ++v)
          chan_merge(n, mu_t, m2_t, v < n_valid ? (float)((n_valid - v + G - 1) / G) : 0.0f, red[v * CO + wtid],
                     red[G * CO + v * CO + wtid]);
        const size_t o = ((size_t)b * CO + wtid) * g.n_tiles + tile;
        part[o] = mu_t;
        part[(size_t)g.batch * CO * g.n_tiles + o] = m2_t;
      }
    }
  }
  if (wtid == 0) bulk_wait();
}

// ---------------------------------------------------------- K2 merge ----

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

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The current device and its SMs, read once per device.
int device_sms(int* dev, int* sms) {
  static int cache[64] = {};
  int rc = static_cast<int>(cudaGetDevice(dev));
  if (rc != 0) return rc;
  if (*dev < 0 || *dev >= 64) return -1;
  if (cache[*dev] == 0 &&
      (rc = static_cast<int>(cudaDeviceGetAttribute(&cache[*dev], cudaDevAttrMultiProcessorCount, *dev))) != 0)
    return rc;
  *sms = cache[*dev];
  return 0;
}

// x's maps over [batch, t_in, c_in] (stride 1: rows t; stride 2: the even
// rows 2q and the odd rows 2q + 1, each a map of its own whose extent ends
// where the tensor does, so TMA zero-fills rows -1 and past t_in at either
// parity of t_in), boxes of one batch row, and y's map over [batch, t_out, CO].
template <int CO, int S>
int bf16_maps(Maps* maps, const Args& a, const Geometry& g) {
  using T = Tile<CO>;
  const cuuint32_t wc = g.width / 2, rows = g.box_rows;
  const cuuint64_t ci = a.c_in, bstride = (cuuint64_t)a.t_in * a.c_in * 2;
  int rc = 0;
  if (g.tma) {
    const cuuint32_t main[3] = {wc, rows, 1}, tail[3] = {wc, S == 1 ? 2u : 1u, 1};
    if (S == 1) {
      const cuuint64_t dims[3] = {ci, (cuuint64_t)a.t_in, (cuuint64_t)a.batch}, strides[2] = {ci * 2, bstride};
      if ((rc = bf16_map(&maps->x[0], a.x, 3, dims, strides, main)) != 0 ||
          (rc = bf16_map(&maps->x[1], a.x, 3, dims, strides, tail)) != 0)
        return rc;
    } else {
      const cuuint64_t even[3] = {ci, (cuuint64_t)(a.t_in + 1) / 2, (cuuint64_t)a.batch};
      const cuuint64_t odd[3] = {ci, (cuuint64_t)a.t_in / 2, (cuuint64_t)a.batch}, strides[2] = {ci * 4, bstride};
      const bf16* x1 = static_cast<const bf16*>(a.x) + a.c_in;  // row 1
      if ((rc = bf16_map(&maps->x[0], a.x, 3, even, strides, main)) != 0 ||
          (rc = bf16_map(&maps->x[1], x1, 3, odd, strides, main)) != 0 ||
          (rc = bf16_map(&maps->x[2], x1, 3, odd, strides, tail)) != 0)
        return rc;
    }
  }
  const cuuint64_t dims[3] = {CO, (cuuint64_t)a.t_out, (cuuint64_t)a.batch};
  const cuuint64_t strides[2] = {CO * 2, (cuuint64_t)a.t_out * CO * 2};
  const cuuint32_t box[3] = {T::kYCols, rows, 1};
  return bf16_map(&maps->y, a.y, 3, dims, strides, box);
}

template <int CO, int S, bool STATS>
int launch_bf16(const Args& a) {
  using T = Tile<CO>;
  Geometry g{};
  size_t smem = 0;
  if (!bf16_geometry<CO, S>(a.c_in, &g, &smem) || !aligned16(a.y)) return -1;
  const long n_tiles = (a.t_out + g.rows - 1) / g.rows, items = (long)a.batch * n_tiles;
  if (items >= (1L << 30)) return -1;  // item + 2 gridDim.x stays an int
  g.batch = a.batch, g.t_in = a.t_in, g.t_out = a.t_out, g.c_in = a.c_in, g.act = a.act;
  g.n_tiles = static_cast<int>(n_tiles), g.n_items = static_cast<int>(items);
  g.tma = a.c_in % 8 == 0 && aligned16(a.x) && (S == 1 || a.t_in >= 2);
  g.w_vec = aligned16(a.w);
  Maps maps = {};  // x's maps stay unused when the producer stages x itself
  int dev = 0, sms = 0, rc = 0;
  if ((rc = bf16_maps<CO, S>(&maps, a, g)) != 0 || (rc = device_sms(&dev, &sms)) != 0) return rc;
  const auto kernel = conv_k3_wgmma_kernel<CO, S, STATS>;
  static bool opted_in[64] = {};  // per device: the kernel may take kMaxSmem
  if (!opted_in[dev]) {
    if ((rc = static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                    static_cast<int>(kMaxSmem)))) != 0)
      return rc;
    opted_in[dev] = true;
  }
  const int grid = static_cast<int>(items < sms ? items : sms);
  kernel<<<grid, kBlock, smem, a.stream>>>(maps, static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.w),
                                           static_cast<const bf16*>(a.bias), a.mu, a.inv, a.part, g);
  rc = static_cast<int>(cudaGetLastError());
  return rc != 0 || !STATS ? rc : merge(a, CO, g.n_tiles, g.rows);
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
  size_t smem = 0;
  Geometry g{};
  switch (c_out * 2 + stride) {
    case 33: return bf16_geometry<16, 1>(c_in, &g, &smem) ? g.rows : 0;
    case 34: return bf16_geometry<16, 2>(c_in, &g, &smem) ? g.rows : 0;
    case 65: return bf16_geometry<32, 1>(c_in, &g, &smem) ? g.rows : 0;
    case 66: return bf16_geometry<32, 2>(c_in, &g, &smem) ? g.rows : 0;
    case 129: return bf16_geometry<64, 1>(c_in, &g, &smem) ? g.rows : 0;
    case 130: return bf16_geometry<64, 2>(c_in, &g, &smem) ? g.rows : 0;
    case 257: return bf16_geometry<128, 1>(c_in, &g, &smem) ? g.rows : 0;
    case 258: return bf16_geometry<128, 2>(c_in, &g, &smem) ? g.rows : 0;
    default: return 0;
  }
}

// Dynamic shared memory in bytes of a bf16 launch with these arguments
// (its ring of ring_stages stages); 0 if unsupported.
extern "C" int w2s_conv_k3_smem(int c_out, int c_in, int stride, int* ring_stages) {
  size_t smem = 0;
  Geometry g{};
  bool ok = false;
  switch (c_out * 2 + stride) {
    case 33: ok = bf16_geometry<16, 1>(c_in, &g, &smem); break;
    case 34: ok = bf16_geometry<16, 2>(c_in, &g, &smem); break;
    case 65: ok = bf16_geometry<32, 1>(c_in, &g, &smem); break;
    case 66: ok = bf16_geometry<32, 2>(c_in, &g, &smem); break;
    case 129: ok = bf16_geometry<64, 1>(c_in, &g, &smem); break;
    case 130: ok = bf16_geometry<64, 2>(c_in, &g, &smem); break;
    case 257: ok = bf16_geometry<128, 1>(c_in, &g, &smem); break;
    case 258: ok = bf16_geometry<128, 2>(c_in, &g, &smem); break;
    default: break;
  }
  if (ring_stages) *ring_stages = ok ? g.stages : 0;
  return ok ? static_cast<int>(smem) : 0;
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
