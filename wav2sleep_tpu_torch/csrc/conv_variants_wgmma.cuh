// V2, V3, V4 and V7 of the K1 bisection ladder on Hopper's wgmma and TMA,
// sm_90a. Included by conv_variants.cu, which dispatches modes 2, 3, 4 and 7
// here.
//
//   V2 (scripts/profile_pallas_variants.py:85, k_mm1f)   y = bf16(x @ W0)
//   V3 (scripts/profile_pallas_variants.py:93, k_mm3)    y = bf16(x @ W0 + x @ W1 + x @ W2)
//   V4 (scripts/profile_pallas_variants.py:106, k_mm3s)  y[i] = bf16(x[i] @ W1
//        + (i % tb != 0 ? x[i - 1] @ W0 : 0) + (i % tb != tb - 1 ? x[i + 1] @ W2 : 0))
//   V7 (scripts/profile_pallas_variants.py:136, k_v7)    per function tile F of tb rows,
//        y = bf16([xp[8F], x[:-1]] @ W0 + x @ W1 + [x[1:], xn[8F]] @ W2)
//
// x and y are [batch, nb, 128] bf16, W [taps, 128, 128] bf16 used as x @ W[j]
// (K1's [taps, C_in, C_out]), f32 sums, one rounding to bf16. All four are
// taken over the flat [batch * nb, 128] rows: V2 and V3 are row-wise, and
// V4's zero edges and V7's halo rows at every multiple of tb include the
// batch edges (nb is a multiple of tb). V7's halo rows are row 8F of the
// flat [batch * (nb / tb) * 8, 128] rows of xp and xn, F = b (nb / tb) + f.
//
// What bounds them on an H100 (SXM, 700 W, x [8, 153,600, 128]): bytes. x is
// read once and y written once, 2 x 1,228,800 x 256 bytes, 0.1878 ms at 3.35
// TB/s (V7's halo rows and W add 0.1879). V3, V4 and V7 do 768 FLOPs a row
// for 256 bytes read (192 a byte, under the ~295 where the bf16 tensor cores
// stop being bound by HBM): 0.122 ms at 989 TFLOP/s; V2 a third of that.
// Measured on an H100 SXM at 700 W (PERF.md), V2 runs at the copy's pace
// while V3's three products draw the card's power limit, so its SM clock
// falls from 1.98 GHz to 1.4-1.8: what is left between V3 and V2 is power,
// not the ring or the feed (a ring of 4 to 10 stages and A from registers
// measured the same).
//
// Why V3 keeps three products: the ladder bisects K1, whose k = 3 conv runs
// three products of shifted rows. Summing W0 + W1 + W2 first would make V3
// V2 with other weights and tell nothing about K1's three taps, so V3 chains
// its 3 x 8 k-steps into one f32 accumulator.
//
// The two sides of K1's tap shift: V7 feeds shifted input rows to the tensor
// cores, as K1 does (tap j of output row i reads row i + j - 1, through a
// descriptor that starts j rows into a window); V4 multiplies the unshifted
// rows and moves the f32 products one row down (W0) and up (W2) in
// registers.
//
// Design (hopper-kernels guide section 1):
// - Persistent blocks, one per SM (grid = min(SMs, tiles)), 384 threads: two
//   consumer warpgroups and one producer warpgroup, of which one thread
//   issues TMA. A tile is at most 64 rows (one wgmma M); local tile k of a
//   block is tile blockIdx.x + k gridDim.x, in ring stage k % S, consumed by
//   warpgroup k % 2 (S is even, so each warpgroup owns every other stage).
//   The two warpgroups run on different tiles, so one's epilogue overlaps
//   the other's products.
// - x comes in through a 2-D tensor map over the [batch * nb, 128] rows,
//   boxes of 64 channels with the 128-byte swizzle (128 bytes is the widest
//   box row that swizzle takes, so a tile is two boxes). Each stage has a
//   full mbarrier (one arrival with the tile's transactions) and an empty
//   one (128 consumer arrivals). Rows past either end of x are zero-filled
//   by TMA: no window or bounds in the kernel.
// - The weights come in once per block, by TMA as well, as they lie: W[j] is
//   [C_in][C_out] with C_out contiguous, i.e. wgmma's B [K][N] N-major, which
//   16-bit wgmma reads with its transpose bit. A map over the [taps x 128,
//   128] rows of W, boxes of 64 outputs x 128 inputs with the 128-byte
//   swizzle, gives per tap two 16 KB halves of the outputs; the descriptor
//   steps 16 KB between them (leading offset) and 1024 bytes between groups
//   of 8 inputs (stride offset), and a k-step of 16 inputs adds 2048 bytes.
// - wgmma.mma_async m64n128k16, A (K-major: the k-step of 16 channels adds
//   32 bytes inside a 128-byte swizzle atom) and B from shared memory, f32
//   accumulators of 64 registers a thread; a product's first k-step has
//   scale-d 0.
// - Epilogue: after the stage is released, the warpgroup waits for its
//   previous TMA store to have read its y buffer, writes its bf16x2 pairs
//   with the same swizzle (conflict-free), fences the async proxy and one
//   thread issues the TMA stores; TMA clips rows past the end of y.
// - Shared memory: V3 6 x 16 KB ring + 2 x 16 KB y + 96 KB W = 224 KB (plus
//   alignment and barriers, under the 227 KB limit); V2 8 x 16 KB + 32 KB +
//   32 KB = 192 KB; V4 4 x 16 KB + 32 KB + 96 KB + 6 KB of exchange rows;
//   V7 4 x 18 KB + 32 KB + 96 KB = 200 KB.
// - Tensor maps are encoded on the host per call with
//   cuTensorMapEncodeTiled, looked up once through the runtime's
//   cudaGetDriverEntryPointByVersion (no -lcuda; hopper.cuh, which also
//   holds the mbarrier, TMA and wgmma helpers), and passed as
//   __grid_constant__ parameters.
//
// V4's shift, on the same loop:
// - Overlapping tiles. Tile k reads rows 62k - 1 .. 62k + 62 and writes rows
//   62k .. 62k + 61 (a y box of 62 rows), so every product an output row
//   needs is in its own tile and no tile waits for another: 64 / 62 of the
//   bytes read and of the products (3.2% more). Handing the edge rows'
//   products between tiles instead would chain the two warpgroups (and the
//   blocks at span edges) to each other.
// - Two accumulators, not three: at 384 threads a thread has 168 registers,
//   and one m64n128 f32 accumulator is 64. The warpgroup runs P0 = x @ W0
//   into a scratch accumulator and P1 = x @ W1 into y's in one group, adds
//   P0 one row down into y's, then runs P2 = x @ W2 into the scratch and
//   adds it one row up. The producer warpgroup gives its registers to the
//   consumers (setmaxnreg 40 / 232), so the two accumulators, the shift's
//   temporaries and the addresses fit without spills.
// - The shift in registers. In the accumulator layout warp w of the
//   warpgroup holds rows 16w .. 16w + 15, lane l rows 16w + l / 4 (its
//   first register half) and 16w + l / 4 + 8 (its second). A shift of one
//   row is one shfl by 4 lanes per value: rows 7 and 8 swap register halves
//   on the way (the sender picks which half it sends), and the one row per
//   warp that crosses to the neighbouring warp goes through 512 bytes of
//   shared memory per warp boundary, after a named barrier of the
//   warpgroup.
// - The zero edges: the lane's two rows' global index i gives i % tb by
//   FastDiv (a multiply and a shift), once per tile; the shifted product is
//   added only where i % tb != 0 (P0) and != tb - 1 (P2).
//
// V7's shift, on the same loop (v7_wgmma_kernel):
// - Tiles aligned to the function's tiles. Each function tile of tb rows is
//   cut into tb / 64 tiles of 64 rows and, where tb % 64 != 0, one of
//   tb % 64 rows (a multiple of 8): tile g is sub-tile g % ceil(tb / 64) of
//   function tile F = g / ceil(tb / 64), by FastDiv. So a function tile's
//   edge is always the edge of a tile's window, never inside it. Small tb
//   pays for its partial tiles in wasted products; at tb 2048 there are
//   none.
// - A 66-row window per tile: the producer loads rows t0 - 1 .. t0 + 64 as
//   two boxes of 66 rows x 64 channels (8,448 bytes, each at a 1024-byte
//   aligned offset, 9 KB apart), 18 KB a stage, a ring of 4.
// - The shift on the input side: tap j's A descriptor starts at window row
//   j, 128 j bytes into the stage, which is inside a 128-byte swizzle atom
//   (1024 bytes); the stride between groups of 8 rows stays 1024 bytes, so
//   row i of the operand is window row i + j. The swizzle is taken from the
//   shared-memory address bits (as TMA wrote it: 16-byte chunk c of the row
//   at address r lies at chunk c ^ ((r >> 7) & 7)), so the descriptor's
//   matrix base-offset field stays 0, as for V2-V4. Measured on an H100 SXM
//   (PERF.md): a base offset of (start >> 7) & 7 = j, the PTX ISA's
//   wording for a start not aligned to the pattern's repeat, read wrong
//   rows in every tile; 0 reads the right ones, since the boxes, which set
//   the pattern's phase, are 1024-byte aligned. The k-step still adds 32
//   bytes inside the atom, so a tile issues V3's 24 wgmma from one window,
//   with nothing shifted in registers.
// - The halo rows patched in shared memory: where a tile starts a function
//   tile, window row 0 (x[t0 - 1], or TMA's zeros before x) is replaced by
//   row 8F of xp; where it ends one, window row rows + 1 by row 8F of xn.
//   Lanes 0-15 and 16-31 of the warpgroup's first warp load the two rows'
//   16-byte chunks from global memory before the tile's full barrier, store
//   them at their swizzled places (chunk c of box row r at r * 128 + (c ^ (r
//   & 7)) * 16) once the tile has landed, fence the async proxy, and the
//   warpgroup meets at its named barrier before its first wgmma. A patched
//   row is read only by the one output row that needs the halo. No second
//   TMA write lands on the window's bytes (two asynchronous writes to the
//   same bytes have no order).
// - The y store: full tiles by the 64-row TMA store; a partial tile by a
//   second y map with 8-row boxes, rows / 8 of them per half, so it writes
//   only its own rows and never the next function tile's, with the same
//   swizzled y buffer (each 8-row box is one 1024-byte atom of it) and the
//   same store path.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace wgmma_mm {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kD = 128;                      // channels in and out
constexpr int kRows = 64;                    // rows per tile: one wgmma M
constexpr int kBoxCols = 64;                 // channels per TMA box: 128 bytes, the swizzle's span
constexpr int kBoxBytes = kRows * 128;       // one box of a tile, 8 KB
constexpr int kTileBytes = 2 * kBoxBytes;    // 16 KB
constexpr int kWHalfBytes = kD * 128;        // one tap's 64 outputs for all 128 inputs
constexpr int kWTapBytes = 2 * kWHalfBytes;  // 32 KB
constexpr int kConsumers = 2;                // warpgroups
constexpr int kThreads = (kConsumers + 1) * 128;
// V4's exchange rows per consumer warpgroup: for each of its two shifts, one
// f32 row per boundary between its four warps.
constexpr int kExBytes = 2 * 3 * kD * 4;
// V7: a window of 66 rows (t0 - 1 .. t0 + 64) per box, each box at a
// 1024-byte aligned offset (8,448 bytes to 9 KB), a ring of 4 stages (6 do
// not fit beside W and the y buffers; an odd ring breaks the ring's order,
// see mm_wgmma_kernel).
constexpr int kV7Rows = kRows + 2;
constexpr int kV7BoxBytes = (kV7Rows * 128 + 1023) / 1024 * 1024;
constexpr int kV7StageBytes = 2 * kV7BoxBytes;
constexpr int kV7Stages = 4;
constexpr size_t kV7Smem = 1024 + (size_t)kV7Stages * kV7StageBytes + (size_t)kConsumers * kTileBytes +
                           3 * (size_t)kWTapBytes + 8 * (2 * kV7Stages + 1);
static_assert(kV7Smem <= 232448, "V7's ring, y buffers and weights fit in a block's shared memory");

// n / d for 0 <= n < 2^31 by a multiply and a shift (CUTLASS's FastDivmod):
// tb is a kernel argument, and an integer division by it costs tens of
// instructions, enough to show on the ladder's rungs.
struct FastDiv {
  int d;
  uint32_t mul, shr;
  __device__ __forceinline__ int div(int n) const {
    return static_cast<int>(__umulhi(static_cast<uint32_t>(n), mul) >> shr);
  }
};

inline FastDiv make_fast_div(int d) {  // d >= 2; for d 1, div is not used (callers test d)
  if (d < 2) return {d, 0, 0};
  int log2 = 31 - __builtin_clz(static_cast<unsigned>(d));
  log2 += (d & (d - 1)) != 0;
  const unsigned p = 31 + log2;
  return {d, static_cast<uint32_t>(((1ull << p) + d - 1) / d), p - 32};
}

// MODE: 1 = V2, 3 = V3, 4 = V4.
template <int MODE>
__host__ __device__ constexpr int taps() { return MODE == 1 ? 1 : 3; }

// Rows of y a tile writes: V4's tiles overlap by two rows.
template <int MODE>
__host__ __device__ constexpr int out_rows() { return MODE == 4 ? kRows - 2 : kRows; }

template <int MODE>
__host__ __device__ constexpr int stages() { return MODE == 1 ? 8 : MODE == 3 ? 6 : 4; }

template <int MODE>
constexpr size_t smem_bytes() {
  return 1024 /* alignment of the swizzled tiles */ + (size_t)(stages<MODE>() + kConsumers) * kTileBytes +
         (size_t)taps<MODE>() * kWTapBytes + (MODE == 4 ? kConsumers * kExBytes : 0) + 8 * (2 * stages<MODE>() + 1);
}

// d (+)= the 64 rows at a @ W[j]: 8 k-steps of 16 channels, the second 64
// channels BOX bytes after the first.
template <int BOX = kBoxBytes>
__device__ __forceinline__ void tap_product(float (&d)[64], uint32_t a, uint32_t ws, int j, bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint32_t a_k = a + (kk / 4) * BOX + (kk % 4) * 32;
    const uint32_t b_k = ws + j * kWTapBytes + kk * 16 * 128;
    wgmma<1>(d, sw128_desc(a_k), sw128_desc(b_k, kWHalfBytes), accumulate || kk > 0);
  }
}

// Thread 0's set-up of a ring of `stages`: full barriers (one arrival and
// the transactions), empty ones (128 consumer arrivals), the weights' one.
__device__ __forceinline__ void init_barriers(uint32_t full, uint32_t empty, uint32_t w_full, int stages) {
  for (int s = 0; s < stages; ++s) {
    mbar_init(full + 8 * s, 1);
    mbar_init(empty + 8 * s, 128);
  }
  mbar_init(w_full, 1);
  fence_mbar_init();
}

// The producer thread's load of the TAPS weight taps into ws.
template <int TAPS>
__device__ __forceinline__ void load_weights(uint32_t ws, const CUtensorMap* w_map, uint32_t w_full) {
  mbar_expect_tx(w_full, TAPS * kWTapBytes);
  for (int j = 0; j < TAPS; ++j)
    for (int h = 0; h < 2; ++h) tma_load(ws + j * kWTapBytes + h * kWHalfBytes, w_map, w_full, h * kBoxCols, j * kD);
}

// The epilogue's first half: once this warpgroup's last TMA store has read
// its y buffer, accumulator row m goes, rounded to bf16, to buffer row
// m + FIRST (rows outside [0, STEP) are dropped) in the 128-byte swizzle;
// then the async proxy is fenced for the TMA store. wtid, warp, lane: the
// thread, its warp in the warpgroup and its lane; bar: the warpgroup's
// named barrier.
template <int FIRST, int STEP>
__device__ __forceinline__ void stage_y(const float (&acc)[64], uint32_t ybuf, int wtid, int warp, int lane, int bar) {
  const int g = lane >> 2, tq = lane & 3;  // accumulator rows warp * 16 + g (+ 8), columns 8i + 2tq (+ 1)
  if (wtid == 0) bulk_wait_read();
  named_bar_sync(bar, 128);
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + g + 8 * h + FIRST;
      if (r < 0 || r >= STEP) continue;
      const uint32_t addr = ybuf + (i / 8) * kBoxBytes + r * 128 + (((i % 8) ^ (r & 7)) << 4) + tq * 4;
      const uint32_t pair = pack_bf16x2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(pair) : "memory");
    }
  }
  fence_async_shared();
  named_bar_sync(bar, 128);
}

// V4: acc[row] += p[row + DIR] (DIR -1: one row down, P0; +1: one row up,
// P2) for the lane's two rows, where keep[h] says the row's term is not cut
// by an edge of the function's tiles. ex: this warpgroup's 3 exchange rows
// for the shift (f32, one per boundary between its warps); bar: its named
// barrier. Row 0 (DIR -1) and row 63 (DIR +1) get no term: they are the
// overlap rows, which this tile does not write.
template <int DIR>
__device__ __forceinline__ void add_shifted(float (&acc)[64], const float (&p)[64], const bool (&keep)[2],
                                            float* ex, int bar, int warp, int lane) {
  const int g = lane >> 2, tq = lane & 3;
  // The one row per warp that crosses to the neighbouring warp: DIR -1
  // sends row 16w + 15 (g 7, second half) to warp w + 1; DIR +1 sends row 16w
  // (g 0, first half) to warp w - 1.
  const int edge_g = DIR < 0 ? 7 : 0;
  const int h_send = DIR < 0 ? 1 : 0;
  const bool sends = g == edge_g && (DIR < 0 ? warp < 3 : warp > 0);
  if (sends) {
    float* row = ex + (DIR < 0 ? warp : warp - 1) * kD;
#pragma unroll
    for (int i = 0; i < kD / 8; ++i)
      *reinterpret_cast<float2*>(row + 8 * i + 2 * tq) = make_float2(p[4 * i + 2 * h_send], p[4 * i + 2 * h_send + 1]);
  }
  named_bar_sync(bar, 128);
  // The lane that holds the wanted rows: 4 lanes back (DIR -1) or on.
  const int src = (lane + (DIR < 0 ? 28 : 4)) & 31;
  // The receiving half that needs a row from the other warp (DIR -1: the
  // first half of g 0; DIR +1: the second half of g 7), and whether this
  // warp has that neighbour (else the row is an overlap row: 0).
  const int recv_g = DIR < 0 ? 0 : 7;
  const int h_recv = DIR < 0 ? 0 : 1;
  const bool has_nb = DIR < 0 ? warp > 0 : warp < 3;
  const float* nb_row = ex + (DIR < 0 ? warp - 1 : warp) * kD;
  // The sender's half that crosses rows 7 | 8: DIR -1, the receiver's
  // second half (row 8) of g 0 wants the sender's (g 7) first half (row 7);
  // DIR +1, the receiver's first half of g 7 (row 7) wants the sender's
  // (g 0) second half (row 8).
  const int swap_g = DIR < 0 ? 7 : 0;
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) {
    float2 cross = make_float2(0.0f, 0.0f);
    if (g == recv_g && has_nb) cross = *reinterpret_cast<const float2*>(nb_row + 8 * i + 2 * tq);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float v0 = p[4 * i + c], v1 = p[4 * i + 2 + c];
      // DIR -1: the second half takes row r - 1, which for g 0 is the
      // sender's first half. DIR +1: the first half takes row r + 1, which
      // for g 7 is the sender's second half.
      const float mixed = __shfl_sync(0xffffffffu, g == swap_g ? (DIR < 0 ? v0 : v1) : (DIR < 0 ? v1 : v0), src);
      const float same = __shfl_sync(0xffffffffu, DIR < 0 ? v0 : v1, src);
      float t0 = DIR < 0 ? same : mixed, t1 = DIR < 0 ? mixed : same;
      if (g == recv_g) {
        if (h_recv == 0) t0 = c ? cross.y : cross.x;
        else t1 = c ? cross.y : cross.x;
      }
      if (keep[0]) acc[4 * i + c] += t0;
      if (keep[1]) acc[4 * i + 2 + c] += t1;
    }
  }
}

// MODE 1 (V2), 3 (V3): y = bf16(sum over taps of x @ W[j]) over n_tiles
// tiles of 64 rows. MODE 4 (V4): y = bf16(x @ W1 + the shifted products)
// over n_tiles overlapping tiles that write 62 rows each.
template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
    mm_wgmma_kernel(__grid_constant__ const CUtensorMap x_map, __grid_constant__ const CUtensorMap y_map,
                    __grid_constant__ const CUtensorMap w_map, int n_tiles, FastDiv tb) {
  constexpr int S = stages<MODE>(), TAPS = taps<MODE>(), STEP = out_rows<MODE>();
  constexpr int kFirstRow = MODE == 4 ? -1 : 0;  // global row of tile row 0, less tile * STEP
  // Each consumer warpgroup owns every other stage, so tiles k and k + S of a
  // stage go to one warpgroup, in order: its wait on the full barrier for
  // tile k + S cannot come before tile k's load has landed, which a parity
  // wait could not tell from tile k + S's.
  static_assert(S % kConsumers == 0, "each consumer warpgroup owns every other stage");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const uint32_t ring = smem_u32(base);
  const uint32_t ys = ring + S * kTileBytes;
  const uint32_t ws = ys + kConsumers * kTileBytes;
  float* ex_all = reinterpret_cast<float*>(base + (ws - ring) + TAPS * kWTapBytes);  // V4 only
  const uint32_t full = ws + TAPS * kWTapBytes + (MODE == 4 ? kConsumers * kExBytes : 0);
  const uint32_t empty = full + 8 * S;  // S full mbarriers, S empty ones, the weights' one
  const uint32_t w_full = empty + 8 * S;
  const int tid = threadIdx.x, wg = tid / 128;

  if (tid == 0) init_barriers(full, empty, w_full, S);
  __syncthreads();

  if (wg == kConsumers) {  // the producer: one thread issues every load
    if constexpr (MODE == 4) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == kConsumers * 128) {
      load_weights<TAPS>(ws, &w_map, w_full);
      for (int k = 0, tile = blockIdx.x; tile < n_tiles; ++k, tile += gridDim.x) {
        const int s = k % S;
        const int row = tile * STEP + kFirstRow;
        mbar_wait(empty + 8 * s, ((k / S) & 1) ^ 1);  // the first round finds every stage free
        mbar_expect_tx(full + 8 * s, kTileBytes);
        tma_load(ring + s * kTileBytes, &x_map, full + 8 * s, 0, row);
        tma_load(ring + s * kTileBytes + kBoxBytes, &x_map, full + 8 * s, kBoxCols, row);
      }
    }
    return;
  }
  if constexpr (MODE == 4) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  mbar_wait(w_full, 0);
  const int wtid = tid % 128, warp = wtid / 32, lane = tid % 32;
  const int g = lane >> 2;  // V4: the lane's accumulator rows are warp * 16 + g (+ 8)
  const uint32_t ybuf = ys + wg * kTileBytes;
  float* ex = ex_all + wg * (kExBytes / 4);
  float acc[64] = {};
  float scratch[MODE == 4 ? 64 : 1] = {};  // V4's P0, then P2
  for (int k = wg, tile = blockIdx.x + wg * gridDim.x; tile < n_tiles;
       k += kConsumers, tile += kConsumers * gridDim.x) {
    const int s = k % S;
    mbar_wait(full + 8 * s, (k / S) & 1);
    const uint32_t a = ring + s * kTileBytes;
    if constexpr (MODE == 4) {
      // The lane's rows and which of their shifted terms an edge of the
      // function's tiles cuts: keep0 for P0 (i % tb != 0), keep2 for P2
      // (i % tb != tb - 1). Row -1 (tile 0's overlap row) is never written.
      bool keep0[2], keep2[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = tile * STEP + kFirstRow + warp * 16 + g + 8 * h;
        const int rem = i - tb.div(i < 0 ? 0 : i) * tb.d;
        keep0[h] = i >= 0 && rem != 0;
        keep2[h] = i >= 0 && rem != tb.d - 1;
      }
      wgmma_fence();
      tap_product(scratch, a, ws, 0, false);  // P0
      tap_product(acc, a, ws, 1, false);      // P1 into y's accumulator
      wgmma_commit();
      wgmma_wait();
      fence_operands(scratch);
      fence_operands(acc);
      add_shifted<-1>(acc, scratch, keep0, ex, 1 + wg, warp, lane);
      wgmma_fence();
      tap_product(scratch, a, ws, 2, false);  // P2
      wgmma_commit();
      wgmma_wait();
      fence_operands(scratch);
      fence_operands(acc);
      mbar_arrive(empty + 8 * s);
      add_shifted<1>(acc, scratch, keep2, ex + 3 * kD, 1 + wg, warp, lane);
    } else {
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < TAPS; ++j) tap_product(acc, a, ws, j, j > 0);
      wgmma_commit();
      wgmma_wait();
      fence_operands(acc);
      mbar_arrive(empty + 8 * s);
    }

    // Epilogue: V4 drops its two overlap rows 0 and 63.
    stage_y<kFirstRow, STEP>(acc, ybuf, wtid, warp, lane, 1 + wg);
    if (wtid == 0) {
      tma_store(&y_map, ybuf, 0, tile * STEP);
      tma_store(&y_map, ybuf + kBoxBytes, kBoxCols, tile * STEP);
      bulk_commit();
    }
  }
  if (wtid == 0) bulk_wait();
}

// V7's tile g: sub-tile g % per_fn of flat function tile F = g / per_fn
// (per_fn = ceil(tb / 64)), whose first row is F tb + 64 (g % per_fn).
struct V7Tile {
  int row;     // flat row of the tile's first output row
  int rows;    // 64, or tb % 64 for the partial last tile of a function tile
  int fn;      // F: the halo rows are row 8F of xp and of xn
  bool first;  // starts a function tile: window row 0 is xp[8F]
  bool last;   // ends one: window row rows + 1 is xn[8F]
};

__device__ __forceinline__ V7Tile v7_tile(int g, FastDiv per_fn, int tb) {
  const int fn = per_fn.d == 1 ? g : per_fn.div(g);
  const int sub = g - fn * per_fn.d;
  const bool last = sub == per_fn.d - 1;
  const int tail = tb % kRows;
  return {fn * tb + sub * kRows, last && tail ? tail : kRows, fn, sub == 0, last};
}

// V7 over n_tiles tiles of the function's tiles (the note at the top).
// x_map: boxes of 66 rows; y_map: 64 rows; y8_map: 8 rows (partial tiles);
// xp, xn: the flat [batch * (nb / tb) * 8, 128] halo rows.
__global__ void __launch_bounds__(kThreads, 1)
    v7_wgmma_kernel(__grid_constant__ const CUtensorMap x_map, __grid_constant__ const CUtensorMap y_map,
                    __grid_constant__ const CUtensorMap y8_map, __grid_constant__ const CUtensorMap w_map,
                    const bf16* __restrict__ xp, const bf16* __restrict__ xn, int n_tiles, FastDiv per_fn, int tb) {
  constexpr int S = kV7Stages;
  static_assert(S % kConsumers == 0, "each consumer warpgroup owns every other stage (mm_wgmma_kernel)");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t ys = ring + S * kV7StageBytes;
  const uint32_t ws = ys + kConsumers * kTileBytes;
  const uint32_t full = ws + 3 * kWTapBytes;
  const uint32_t empty = full + 8 * S;
  const uint32_t w_full = empty + 8 * S;
  const int tid = threadIdx.x, wg = tid / 128;

  if (tid == 0) init_barriers(full, empty, w_full, S);
  __syncthreads();

  if (wg == kConsumers) {  // the producer: one thread issues every load
    if (tid == kConsumers * 128) {
      load_weights<3>(ws, &w_map, w_full);
      for (int k = 0, tile = blockIdx.x; tile < n_tiles; ++k, tile += gridDim.x) {
        const int s = k % S;
        const int row = v7_tile(tile, per_fn, tb).row - 1;  // window row 0
        mbar_wait(empty + 8 * s, ((k / S) & 1) ^ 1);  // the first round finds every stage free
        mbar_expect_tx(full + 8 * s, 2 * kV7Rows * 128);
        tma_load(ring + s * kV7StageBytes, &x_map, full + 8 * s, 0, row);
        tma_load(ring + s * kV7StageBytes + kV7BoxBytes, &x_map, full + 8 * s, kBoxCols, row);
      }
    }
    return;
  }

  mbar_wait(w_full, 0);
  const int wtid = tid % 128, warp = wtid / 32, lane = tid % 32;
  const uint32_t ybuf = ys + wg * kTileBytes;
  float acc[64] = {};
  for (int k = wg, tile = blockIdx.x + wg * gridDim.x; tile < n_tiles;
       k += kConsumers, tile += kConsumers * gridDim.x) {
    const int s = k % S;
    const uint32_t a = ring + s * kV7StageBytes;
    const V7Tile t = v7_tile(tile, per_fn, tb);
    // The halo rows' 16-byte chunks, loaded before the wait: thread c < 16
    // takes chunk c of xp[8F] if the tile starts a function tile, thread
    // 16 + c chunk c of xn[8F] if it ends one.
    const bool patch = wtid < 32 && (wtid < 16 ? t.first : t.last);
    uint4 halo = {};
    if (patch) halo = __ldg(reinterpret_cast<const uint4*>((wtid < 16 ? xp : xn) + (size_t)8 * t.fn * kD) + wtid % 16);
    mbar_wait(full + 8 * s, (k / S) & 1);
    if (t.first || t.last) {
      if (patch) {
        const int r = wtid < 16 ? 0 : t.rows + 1, c = wtid % 16;
        const uint32_t dst = a + (c / 8) * kV7BoxBytes + r * 128 + (((c % 8) ^ (r & 7)) << 4);
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(halo.x), "r"(halo.y), "r"(halo.z),
                     "r"(halo.w)
                     : "memory");
        fence_async_shared();
      }
      named_bar_sync(1 + wg, 128);
    }
    wgmma_fence();
    // Tap j reads window rows j .. j + 63: its descriptors start 128 j bytes
    // into the 1024-byte aligned boxes.
#pragma unroll
    for (int j = 0; j < 3; ++j) tap_product<kV7BoxBytes>(acc, a + j * 128, ws, j, j > 0);
    wgmma_commit();
    wgmma_wait();
    fence_operands(acc);
    mbar_arrive(empty + 8 * s);

    stage_y<0, kRows>(acc, ybuf, wtid, warp, lane, 1 + wg);
    if (wtid == 0) {
      if (t.rows == kRows) {
        tma_store(&y_map, ybuf, 0, t.row);
        tma_store(&y_map, ybuf + kBoxBytes, kBoxCols, t.row);
      } else {  // one 1024-byte atom of the y buffer per 8 rows and half
        for (int q = 0; q < t.rows / 8; ++q) {
          tma_store(&y8_map, ybuf + q * 1024, 0, t.row + 8 * q);
          tma_store(&y8_map, ybuf + kBoxBytes + q * 1024, kBoxCols, t.row + 8 * q);
        }
      }
      bulk_commit();
    }
  }
  if (wtid == 0) bulk_wait();
}

// A map over rows x 128 bf16, boxes of 64 channels x box_rows rows,
// 128-byte swizzle; reads outside the rows give zeros, writes there are
// dropped.
inline int row_map(CUtensorMap* map, const void* ptr, long rows, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kD), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {kD * sizeof(bf16)};
  const cuuint32_t box[2] = {kBoxCols, static_cast<cuuint32_t>(box_rows)};
  return bf16_map(map, ptr, 2, dims, strides, box);
}

template <int MODE>
int launch(const bf16* x, const bf16* w, bf16* y, long rows, int tb, cudaStream_t stream) {
  if (rows < 1 || rows > (1L << 31) - 2 * kRows) return -1;  // TMA's row coordinate is an int
  constexpr int STEP = out_rows<MODE>();
  const int n_tiles = static_cast<int>((rows + STEP - 1) / STEP);
  const void* kernel = reinterpret_cast<const void*>(mm_wgmma_kernel<MODE>);
  constexpr size_t smem = smem_bytes<MODE>();
  CUtensorMap x_map, y_map, w_map;
  int dev = 0, sms = 0, rc = 0;
  if ((rc = row_map(&x_map, x, rows, kRows)) != 0 || (rc = row_map(&y_map, y, rows, STEP)) != 0 ||
      (rc = row_map(&w_map, w, taps<MODE>() * kD, kD)) != 0 ||
      (rc = static_cast<int>(cudaGetDevice(&dev))) != 0 ||
      (rc = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) != 0 ||
      (rc = static_cast<int>(
           cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)))) != 0)
    return rc;
  const int grid = n_tiles < sms ? n_tiles : sms;
  mm_wgmma_kernel<MODE><<<grid, kThreads, smem, stream>>>(x_map, y_map, w_map, n_tiles, make_fast_div(tb));
  return static_cast<int>(cudaGetLastError());
}

// V7 over rows = batch * nb flat rows (tb a multiple of 8 that divides
// them: the caller checks); xp, xn: the flat [rows / tb * 8, 128] halo rows.
inline int launch_v7(const bf16* x, const bf16* w, const bf16* xp, const bf16* xn, bf16* y, long rows, int tb,
                     cudaStream_t stream) {
  if (rows < 1 || rows > (1L << 31) - 2 * kRows) return -1;  // TMA's row coordinate is an int
  const int per_fn = (tb + kRows - 1) / kRows;
  const int n_tiles = static_cast<int>(rows / tb * per_fn);
  const void* kernel = reinterpret_cast<const void*>(v7_wgmma_kernel);
  CUtensorMap x_map, y_map, y8_map, w_map;
  int dev = 0, sms = 0, rc = 0;
  if ((rc = row_map(&x_map, x, rows, kV7Rows)) != 0 || (rc = row_map(&y_map, y, rows, kRows)) != 0 ||
      (rc = row_map(&y8_map, y, rows, 8)) != 0 || (rc = row_map(&w_map, w, 3 * kD, kD)) != 0 ||
      (rc = static_cast<int>(cudaGetDevice(&dev))) != 0 ||
      (rc = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) != 0 ||
      (rc = static_cast<int>(
           cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kV7Smem)))) != 0)
    return rc;
  const int grid = n_tiles < sms ? n_tiles : sms;
  v7_wgmma_kernel<<<grid, kThreads, kV7Smem, stream>>>(x_map, y_map, y8_map, w_map, xp, xn, n_tiles,
                                                       make_fast_div(per_fn), tb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wgmma_mm
