// The grid-wide pieces of the port's cooperative kernels (the `grid`
// variants of csrc/rga_order.cu and csrc/edit_stream.cu): one job row
// spread over every SM, its phases separated by cooperative_groups grid
// barriers inside ONE launch.
//
// Each phase that walks nodes gives CTA b the contiguous slot range
// [b * span, (b + 1) * span) of the flat K-row space, `span` a multiple
// of kGridBlock, walked in block-wide steps so that every thread of a
// CTA runs the same iterations (warp collectives stay converged). A
// phase that scans walks chunks: row-local ranges of at most `clen`
// positions, `per` of them per row, CTA b taking chunks b, b + G, ...;
// each chunk's total lands in a global array that every CTA scans into
// shared memory after the next barrier (GridShape::chunks of them).
//
// Planes written inside the launch are read with plain loads, never
// through the read-only path (no const __restrict__, no __ldg), and each
// barrier is cooperative_groups' grid.sync(), whose fences make the
// writes before it visible to every CTA after it. The grid never
// exceeds the blocks the card holds resident at once, so the barrier
// cannot wait on a block that is not running.
#pragma once

#include <climits>
#include <cstddef>
#include <cstdint>
#include <mutex>
#include <utility>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "smem.cuh"

constexpr int kGridBlock = 512;       // threads of a grid-variant CTA
constexpr int kGridRowWin = 16;       // rows of a CTA's shared counters
constexpr int kGridMaxCtas = 1024;    // CTAs a grid launch may take
// The most job rows a grid launch takes (its chunk table lives in
// shared memory) and the most slots (rows times row width), so that
// every slot index stays an int. device/cuda_grid.py mirrors both.
constexpr int kGridMaxRows = 8192;
constexpr long long kGridMaxSlots = INT_MAX / 8;

// Words of a launch's chunk table over `rows` rows (per <= ctas / rows
// chunks a row, so chunks <= max(rows, ctas)); the dynamic shared memory
// of its scan takes one more.
inline int grid_chunk_words(int rows) {
  return rows > kGridMaxCtas ? rows : kGridMaxCtas;
}

struct GridShape {
  int ctas;    // CTAs of the launch
  int span;    // slots per CTA, a multiple of kGridBlock
  int per;     // chunks per row (or per row and class)
  int clen;    // positions (or words) per chunk
  int chunks;  // rows * per
  int regs;    // block steps of a CTA's span (the slots a thread keeps)
};

// The grid of a launch over `total` slots of `rows` rows whose chunked
// phase scans `width` items a row: as many CTAs as the card holds
// resident for every kernel in `fns` (the launch picks one of them by
// gs->regs afterwards) at `smem` bytes of dynamic shared memory, to
// which each is opted in, or fewer when the slots run out first. The
// residency is queried once per device and `smem` (the latest pair is
// kept), not at every launch.
template <typename... F>
inline cudaError_t grid_shape(size_t smem, long long total, int rows,
                              int width, GridShape* gs, F*... fns) {
  static std::mutex mu;
  static int c_dev = -1, c_sms = 0, c_per = 0;
  static size_t c_smem = 0;
  int dev = 0, sms = 0, per_sm = INT_MAX;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (dev != c_dev || smem != c_smem) {
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      auto fit = [&](auto* fn) {
        int b = 0;
        if (e == cudaSuccess) e = opt_in_smem(fn, smem);
        if (e == cudaSuccess) {
          e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, fn,
                                                            kGridBlock, smem);
        }
        per_sm = b < per_sm ? b : per_sm;
      };
      (fit(fns), ...);
      if (e != cudaSuccess) return e;
      c_dev = dev;
      c_smem = smem;
      c_sms = sms;
      c_per = per_sm;
    }
    sms = c_sms;
    per_sm = c_per;
  }
  const long long resident = static_cast<long long>(per_sm) * sms;
  if (resident < 1 || total < 1 || total > kGridMaxSlots) {
    return cudaErrorInvalidConfiguration;
  }
  const long long cap = resident < kGridMaxCtas ? resident : kGridMaxCtas;
  const long long steps = (total + kGridBlock - 1) / kGridBlock;
  const long long want = steps < cap ? steps : cap;
  const long long span_steps = (steps + want - 1) / want;
  gs->span = static_cast<int>(span_steps * kGridBlock);
  gs->ctas = static_cast<int>((total + gs->span - 1) / gs->span);
  gs->regs = static_cast<int>(span_steps);
  int per = gs->ctas / rows;
  per = per < 1 ? 1 : (per > width ? width : per);
  gs->per = per;
  gs->clen = (width + per - 1) / per;
  gs->chunks = rows * per;
  return cudaSuccess;
}

// Launch `fn` cooperatively on gs.ctas CTAs (all resident, so its
// grid.sync() is legal); returns the launch's error.
template <typename... P, typename... A>
inline cudaError_t grid_launch(void (*fn)(P...), const GridShape& gs,
                               size_t smem, cudaStream_t stream,
                               A&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gs.ctas);
  cfg.blockDim = dim3(kGridBlock);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, fn,
                                           std::forward<A>(args)...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// body(j, g) for each block step of a CTA's span [lo, lo + steps *
// kGridBlock): g the thread's slot, which may lie past the span's end,
// and j its register slot — the step, unrolled, when the kernel keeps C
// slots a thread in registers, 0 when it keeps none (C = 0). Every
// thread of the CTA runs the same steps.
template <int C, typename F>
__device__ __forceinline__ void grid_each(int lo, int steps, F&& body) {
  if constexpr (C > 0) {
#pragma unroll
    for (int s = 0; s < C; ++s) body(s, lo + s * kGridBlock + threadIdx.x);
  } else {
    for (int s = 0; s < steps; ++s) {
      body(0, lo + s * kGridBlock + threadIdx.x);
    }
  }
}

// Add each lane's counts v[0..NV) into dst[k * NV + c] for the row k of
// its slot. A warp's lanes hold nondecreasing rows; a lane without a
// slot passes k < 0 and zeros. A warp whose lanes share one row sums in
// registers and adds once into the CTA's shared window `win` (rows
// k_lo .. k_lo + kGridRowWin - 1), or into dst past it; a warp that
// straddles rows adds lane by lane. Called by every lane of the warp.
template <int NV>
__device__ __forceinline__ void warp_row_add(int* win, int k_lo, int* dst,
                                             int k, const int (&v)[NV]) {
  const unsigned full = 0xffffffffu;
  const int k0 = __shfl_sync(full, k, 0);
  if (__all_sync(full, k == k0 || k < 0)) {
    int s[NV];
#pragma unroll
    for (int c = 0; c < NV; ++c) s[c] = __reduce_add_sync(full, v[c]);
    if ((threadIdx.x & 31) == 0 && k0 >= 0) {
      const int r = k0 - k_lo;
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        if (!s[c]) continue;
        if (r >= 0 && r < kGridRowWin) {
          atomicAdd(win + r * NV + c, s[c]);
        } else {
          atomicAdd(dst + static_cast<size_t>(k0) * NV + c, s[c]);
        }
      }
    }
  } else if (k >= 0) {
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      if (v[c]) atomicAdd(dst + static_cast<size_t>(k) * NV + c, v[c]);
    }
  }
}

// Zero the CTA's shared window (then __syncthreads before use).
template <int NV>
__device__ __forceinline__ void row_win_clear(int* win) {
  for (int r = threadIdx.x; r < kGridRowWin * NV; r += blockDim.x) win[r] = 0;
}

// Add the CTA's shared window into dst (after a __syncthreads).
template <int NV>
__device__ __forceinline__ void row_win_flush(const int* win, int k_lo,
                                              int rows, int* dst) {
  for (int r = threadIdx.x; r < kGridRowWin * NV; r += blockDim.x) {
    const int k = k_lo + r / NV;
    if (win[r] && k < rows) {
      atomicAdd(dst + static_cast<size_t>(k) * NV + r % NV, win[r]);
    }
  }
}

// Every CTA: the exclusive scan of the `n` chunk totals into cs[0..n]
// (cs[n] the sum), with BlockScan temp storage `tmp`.
template <typename BlockScan>
__device__ __forceinline__ void scan_chunks(
    const int32_t* sums, int n, int32_t* cs,
    typename BlockScan::TempStorage& tmp) {
  int carry = 0;
  for (int b = 0; b < n; b += kGridBlock) {
    const int q = b + threadIdx.x;
    const int x = q < n ? sums[q] : 0;
    int y, tot;
    BlockScan(tmp).ExclusiveSum(x, y, tot);
    if (q < n) cs[q] = carry + y;
    carry += tot;
    __syncthreads();
  }
  if (threadIdx.x == 0) cs[n] = carry;
  __syncthreads();
}
