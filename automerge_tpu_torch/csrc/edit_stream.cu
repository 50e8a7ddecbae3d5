// Edit-stream kernel: winner/visibility diff -> pre-ordered, delta-sized
// edit buffers for every dirty sequence object, in three variants.
//
// Replaces the TPU kernel in automerge_tpu/device/pallas_view.py:145-258
// (_make_edit_kernel, _edit_stream_pallas_core, edit_stream_pallas).
// That kernel sends every scatter and gather through one-hot MXU
// matmuls because the TPU has no fast gather; on Hopper a gather is a
// plain indexed load, so this kernel does what the plain version
// (cuda_view._edit_core) does, directly:
//
//   per job row k, each node falls into at most one class:
//       remove: pv & ~nv          key = prior idx   vals = (prior idx)
//       insert: nv & ~pv          key = new idx     vals = (node, new idx)
//       set:    nv & pv & touched key = new idx     vals = (node, new idx)
//     a node's rank in its class is the number of class members with a
//     smaller key (the keys are dense, unique visible indexes); it writes
//     its vals at that rank when rank < e_pad (larger ranks are dropped,
//     as in the reference); cnt[k, c] = number of class members (not
//     clamped to e_pad); every other slot below e_pad holds -1
//
// The vis planes are decoded in the loads (the packed word
// prior_vis<<31 | visible<<30 | (prior_idx+1)<<15 | (new_idx+1), the
// wide format's two words prior_vis<<22 | (prior_idx+1) and
// visible<<22 | (new_idx+1) — reference pallas_view.edit_stream_wide —
// or the four cols planes), and touched is read straight from the
// np.packbits plane (MSB first).
//
// Presence is a bitmask: for each class, ceil(m/32) words with bit
// clamp(key, 0, m-1) set (atomicOr). Each word carries the exclusive
// prefix of the popcounts of the words below it, so a node's rank is
// prefix[key/32] + popc(word[key/32] & bits below key) — one 8-byte
// shared-memory load. The prefix runs over words, not nodes (32 to a
// word), and the number of set bits of a class marks where its -1 fill
// starts, so each output slot is written exactly once.
//
// Warp variant (es_warp_kernel; the port dispatches m <=
// cuda_view.M_WARP_ES to it): one warp per job row, several rows per CTA,
// only __syncwarp between the steps. Each lane decodes its nodes
// (l = 32t + lane) once into registers (class and key) for m <= 1024, the
// counts come from warp reductions, and the prefix over words is a warp
// shuffle scan. Above m = 1024 the same kernel decodes a node again for
// its rank (the second read comes from L1/L2).
//
// Block variant (es_block_kernel, wider rows): one thread block per row,
// the same bitmasks in the block's shared memory (24 bytes per 32 nodes:
// 6 KB per class pair at the packed format's 32,767 nodes), a CUB block
// scan over the words in chunks with a carried offset, a second decode
// for the ranks. Past the shared-memory cap (about 270k nodes) the
// bitmasks live in a global scratch of K * 6 * ceil(m/32) words that the
// caller allocates.
//
// Grid variant (es_grid_kernel, a few wide rows: a long text's one row
// would leave all SMs but one idle under the block variant): the same
// bitmasks in a global scratch, the rows spread over every resident CTA
// in four phases of ONE cooperative launch with grid barriers between
// them (csrc/grid.cuh): clear; decode once (class and key kept in
// registers), mark and count; the popcount prefix over chunks of words;
// emit at the ranks and fill. Three barriers and one pass over the
// input set its time.
//
// Bound on the H100: per call it must read K*m*4 + K*ceil(m/8) bytes
// (packed) and write 5*K*e_pad*4 + 12*K bytes, with O(K*m) integer work:
// memory- and latency-bound, far below any arithmetic limit. The warp
// variant reads each input byte once, keeps no [K, m] scratch, and runs
// a row in about ten warp-synchronous steps.

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

#include "grid.cuh"
#include "smem.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemLimit = 200 * 1024;
constexpr int kWarpMaxRows = 8;       // job rows (warps) per CTA
constexpr int kBlock = 512;           // threads of the block variant
constexpr int kNone = 3;              // class of a node in no class
constexpr int kFmtPacked = 0;         // vis: the packed word plane
constexpr int kFmtWide = 2;           // vis, nip: the two wide word planes
constexpr uint32_t kWideIdxMask = (1u << 22) - 1u;
constexpr int kWideVisShift = 22;

__host__ __device__ inline int n_words(int m) { return (m + 31) >> 5; }

// 32-bit words of one row's bitmasks: (mask, prefix) per word per class
__host__ __device__ inline size_t row_words(int m) {
  return static_cast<size_t>(6) * n_words(m);
}

// class of node l and its key (the raw index it ranks by and writes)
__device__ __forceinline__ int classify(int fmt, const int32_t* vis,
                                        const uint8_t* pvp,
                                        const uint8_t* nvp,
                                        const int32_t* pip,
                                        const int32_t* nip,
                                        const uint8_t* trow, size_t off,
                                        int l, int* key) {
  bool pv, nv;
  int pi, ni;
  if (fmt == kFmtPacked) {
    const uint32_t v = static_cast<uint32_t>(__ldg(vis + off + l));
    pv = (v >> 31) & 1u;
    nv = (v >> 30) & 1u;
    pi = static_cast<int>((v >> 15) & 0x7FFFu) - 1;
    ni = static_cast<int>(v & 0x7FFFu) - 1;
  } else if (fmt == kFmtWide) {
    const uint32_t a = static_cast<uint32_t>(__ldg(vis + off + l));
    const uint32_t b = static_cast<uint32_t>(__ldg(nip + off + l));
    pv = (a >> kWideVisShift) & 1u;
    nv = (b >> kWideVisShift) & 1u;
    pi = static_cast<int>(a & kWideIdxMask) - 1;
    ni = static_cast<int>(b & kWideIdxMask) - 1;
  } else {
    pv = __ldg(pvp + off + l) != 0;
    nv = __ldg(nvp + off + l) != 0;
    pi = __ldg(pip + off + l);
    ni = __ldg(nip + off + l);
  }
  if (pv && !nv) {
    *key = pi;
    return 0;
  }
  *key = ni;
  if (nv && !pv) return 1;
  if (nv && pv && ((__ldg(trow + (l >> 3)) >> (7 - (l & 7))) & 1)) return 2;
  return kNone;
}

__device__ __forceinline__ int clamp_key(int key, int m) {
  return min(max(key, 0), m - 1);
}

// set the presence bit of a classified node (pm: the row's bitmasks)
__device__ __forceinline__ void mark(uint32_t* pm, int nw, int c, int key,
                                     int m) {
  const int kc = clamp_key(key, m);
  atomicOr(pm + 2 * (c * nw + (kc >> 5)), 1u << (kc & 31));
}

// no rank offset: the warp and block variants' prefix covers the row
struct NoOffset {
  __device__ __forceinline__ int operator()(int) const { return 0; }
};

// write a classified node's values at its rank (dropped at e_pad and up);
// off(w) adds the set bits before the chunk of word w, where the prefix
// restarts at each chunk (the grid variant)
template <typename Off = NoOffset>
__device__ __forceinline__ void emit(const uint32_t* pm, int nw, int c,
                                     int key, int l, int m, int e_pad,
                                     size_t eoff, int32_t* rm_idx,
                                     int32_t* ins_node, int32_t* ins_idx,
                                     int32_t* set_node, int32_t* set_idx,
                                     Off off = Off()) {
  const int kc = clamp_key(key, m);
  const int w = kc >> 5;
  const uint2 e = *reinterpret_cast<const uint2*>(pm + 2 * (c * nw + w));
  const int r = static_cast<int>(e.y) + off(w) +
                __popc(e.x & ((1u << (kc & 31)) - 1u));
  if (r >= e_pad) return;
  if (c == 0) {
    rm_idx[eoff + r] = key;
  } else if (c == 1) {
    ins_node[eoff + r] = l;
    ins_idx[eoff + r] = key;
  } else {
    set_node[eoff + r] = l;
    set_idx[eoff + r] = key;
  }
}

// the -1 fill: slots at or past each class's number of set bits
__device__ __forceinline__ void fill(int e, int e_pad, const int bits[3],
                                     size_t eoff, int32_t* rm_idx,
                                     int32_t* ins_node, int32_t* ins_idx,
                                     int32_t* set_node, int32_t* set_idx) {
  if (e >= e_pad) return;
  if (e >= bits[0]) rm_idx[eoff + e] = -1;
  if (e >= bits[1]) {
    ins_node[eoff + e] = -1;
    ins_idx[eoff + e] = -1;
  }
  if (e >= bits[2]) {
    set_node[eoff + e] = -1;
    set_idx[eoff + e] = -1;
  }
}

// ---- warp variant: one warp per job row ----------------------------------

// C > 0: a lane keeps its C nodes (l = 32t + lane) decoded in registers,
// m <= 32*C. C == 0: any m; pass 2 decodes again.
template <int C>
__global__ void __launch_bounds__(32 * kWarpMaxRows)
es_warp_kernel(int fmt, const int32_t* __restrict__ vis,
               const uint8_t* __restrict__ pvp,
               const uint8_t* __restrict__ nvp,
               const int32_t* __restrict__ pip,
               const int32_t* __restrict__ nip,
               const uint8_t* __restrict__ touched,
               int32_t* __restrict__ rm_idx, int32_t* __restrict__ ins_node,
               int32_t* __restrict__ ins_idx,
               int32_t* __restrict__ set_node,
               int32_t* __restrict__ set_idx, int32_t* __restrict__ cnt,
               int K, int m, int mb, int e_pad) {
  extern __shared__ __align__(16) uint32_t es_smem[];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int k = blockIdx.x * (blockDim.x >> 5) + wid;
  if (k >= K) return;
  const int nw = n_words(m);
  uint32_t* pm = es_smem + wid * row_words(m);
  const size_t off = static_cast<size_t>(k) * m;
  const size_t eoff = static_cast<size_t>(k) * e_pad;
  const uint8_t* trow = touched + static_cast<size_t>(k) * mb;

  for (int w = lane; w < 3 * nw; w += 32) pm[2 * w] = 0;
  __syncwarp();

  // pass 1: classify, mark presence, count
  constexpr int CR = C > 0 ? C : 1;
  int key[CR];
  uint32_t cls[(CR + 15) / 16];      // 2 bits a node
  int mine[3] = {0, 0, 0};
  if constexpr (C > 0) {
#pragma unroll
    for (int q = 0; q < (CR + 15) / 16; ++q) cls[q] = 0;
#pragma unroll
    for (int t = 0; t < C; ++t) {
      const int l = 32 * t + lane;
      int c = kNone;
      key[t] = 0;
      if (l < m) {
        c = classify(fmt, vis, pvp, nvp, pip, nip, trow, off, l, &key[t]);
        if (c != kNone) {
          mark(pm, nw, c, key[t], m);
          ++mine[c];
        }
      }
      cls[t >> 4] |= static_cast<uint32_t>(c) << (2 * (t & 15));
    }
  } else {
    for (int l = lane; l < m; l += 32) {
      int kk;
      const int c = classify(fmt, vis, pvp, nvp, pip, nip, trow, off, l, &kk);
      if (c != kNone) {
        mark(pm, nw, c, kk, m);
        ++mine[c];
      }
    }
  }
  __syncwarp();

  // exclusive prefix of the word popcounts, per class (shuffle scan over
  // 32 words at a time, carried); bits = set bits of the class
  int bits[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    int carry = 0;
    for (int w0 = 0; w0 < nw; w0 += 32) {
      const int w = w0 + lane;
      const int x = w < nw ? __popc(pm[2 * (c * nw + w)]) : 0;
      int inc = x;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, inc, d);
        if (lane >= d) inc += y;
      }
      if (w < nw) pm[2 * (c * nw + w) + 1] = carry + inc - x;
      carry += __shfl_sync(kFull, inc, 31);
    }
    bits[c] = carry;
  }
  __syncwarp();

  // pass 2: every member writes at its rank; the fill takes the rest
  if constexpr (C > 0) {
#pragma unroll
    for (int t = 0; t < C; ++t) {
      const int c = (cls[t >> 4] >> (2 * (t & 15))) & 3;
      if (c != kNone) {
        emit(pm, nw, c, key[t], 32 * t + lane, m, e_pad, eoff, rm_idx,
             ins_node, ins_idx, set_node, set_idx);
      }
    }
  } else {
    for (int l = lane; l < m; l += 32) {
      int kk;
      const int c = classify(fmt, vis, pvp, nvp, pip, nip, trow, off, l, &kk);
      if (c != kNone) {
        emit(pm, nw, c, kk, l, m, e_pad, eoff, rm_idx, ins_node, ins_idx,
             set_node, set_idx);
      }
    }
  }
  for (int e = lane; e < e_pad; e += 32) {
    fill(e, e_pad, bits, eoff, rm_idx, ins_node, ins_idx, set_node,
         set_idx);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) mine[c] = __reduce_add_sync(kFull, mine[c]);
  if (lane == 0) {
    cnt[static_cast<size_t>(k) * 3] = mine[0];
    cnt[static_cast<size_t>(k) * 3 + 1] = mine[1];
    cnt[static_cast<size_t>(k) * 3 + 2] = mine[2];
  }
}

// ---- block variant: one thread block per job row -------------------------

__global__ void __launch_bounds__(kBlock)
es_block_kernel(int fmt, const int32_t* __restrict__ vis,
                const uint8_t* __restrict__ pvp,
                const uint8_t* __restrict__ nvp,
                const int32_t* __restrict__ pip,
                const int32_t* __restrict__ nip,
                const uint8_t* __restrict__ touched,
                int32_t* __restrict__ rm_idx,
                int32_t* __restrict__ ins_node,
                int32_t* __restrict__ ins_idx,
                int32_t* __restrict__ set_node,
                int32_t* __restrict__ set_idx, int32_t* __restrict__ cnt,
                uint32_t* scratch, int m, int mb, int e_pad, int use_smem) {
  using BlockScan = cub::BlockScan<int, kBlock>;
  __shared__ typename BlockScan::TempStorage scan_tmp;
  __shared__ int s_count[3];
  extern __shared__ __align__(16) uint32_t es_smem[];

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int nw = n_words(m);
  uint32_t* pm = use_smem ? es_smem : scratch + k * row_words(m);
  const size_t off = static_cast<size_t>(k) * m;
  const size_t eoff = static_cast<size_t>(k) * e_pad;
  const uint8_t* trow = touched + static_cast<size_t>(k) * mb;

  for (int w = tid; w < 3 * nw; w += kBlock) pm[2 * w] = 0;
  if (tid < 3) s_count[tid] = 0;
  __syncthreads();

  int mine[3] = {0, 0, 0};
  for (int l = tid; l < m; l += kBlock) {
    int kk;
    const int c = classify(fmt, vis, pvp, nvp, pip, nip, trow, off, l, &kk);
    if (c != kNone) {
      mark(pm, nw, c, kk, m);
      ++mine[c];
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (mine[c]) atomicAdd(&s_count[c], mine[c]);
  }
  __syncthreads();

  int bits[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    int carry = 0;
    for (int w0 = 0; w0 < nw; w0 += kBlock) {
      const int w = w0 + tid;
      const int x = w < nw ? __popc(pm[2 * (c * nw + w)]) : 0;
      int y, total;
      BlockScan(scan_tmp).ExclusiveSum(x, y, total);
      if (w < nw) pm[2 * (c * nw + w) + 1] = carry + y;
      carry += total;
      __syncthreads();     // scan_tmp reuse
    }
    bits[c] = carry;
  }

  for (int l = tid; l < m; l += kBlock) {
    int kk;
    const int c = classify(fmt, vis, pvp, nvp, pip, nip, trow, off, l, &kk);
    if (c != kNone) {
      emit(pm, nw, c, kk, l, m, e_pad, eoff, rm_idx, ins_node, ins_idx,
           set_node, set_idx);
    }
  }
  for (int e = tid; e < e_pad; e += kBlock) {
    fill(e, e_pad, bits, eoff, rm_idx, ins_node, ins_idx, set_node,
         set_idx);
  }
  if (tid < 3) cnt[static_cast<size_t>(k) * 3 + tid] = s_count[tid];
}

// ---- grid variant: one row over every SM ---------------------------------

// The three steps as grid-wide phases of ONE cooperative launch
// (csrc/grid.cuh) over all K rows, on the block variant's bitmasks in a
// global scratch (the (mask, prefix) word pairs of K*3 row-classes) and
// a chunk table:
//
//   phase 0: clear the masks and the counts
//   phase 1: each thread decodes its nodes once, keeps class and key in
//            registers (C block steps; C = 0 decodes again in phase 3),
//            sets the presence bit (atomicOr) and counts its classes
//            (per warp, then per CTA, into cnt)
//   phase 2: each CTA scans the popcounts over its chunks of words of a
//            row-class; the words keep the in-chunk prefix, each
//            chunk's total goes to chunk_sums
//   phase 3: each CTA scans the chunk totals into shared memory; a
//            member's rank is its word's prefix + its chunk's offset in
//            the row-class + the popcount below its bit, written below
//            e_pad; the -1 fill starts at each class's set-bit count
template <int C>
__global__ void __launch_bounds__(kGridBlock)
es_grid_kernel(int fmt, const int32_t* __restrict__ vis,
               const uint8_t* __restrict__ pvp,
               const uint8_t* __restrict__ nvp,
               const int32_t* __restrict__ pip,
               const int32_t* __restrict__ nip,
               const uint8_t* __restrict__ touched,
               int32_t* __restrict__ rm_idx, int32_t* __restrict__ ins_node,
               int32_t* __restrict__ ins_idx,
               int32_t* __restrict__ set_node,
               int32_t* __restrict__ set_idx, int32_t* cnt, uint32_t* pm,
               int32_t* chunk_sums, int K, int m, int mb, int e_pad,
               GridShape gs) {
  using BlockScan = cub::BlockScan<int, kGridBlock>;
  __shared__ typename BlockScan::TempStorage scan_tmp;
  __shared__ int win[kGridRowWin * 3];
  extern __shared__ int32_t cs[];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();

  const int nw = n_words(m);
  const int total = K * m;
  const int tid = threadIdx.x;
  const int lo = blockIdx.x * gs.span;
  const int hi = min(lo + gs.span, total);
  const int steps = (hi - lo + kGridBlock - 1) / kGridBlock;
  const int stride = gridDim.x * kGridBlock;
  constexpr int CR = C > 0 ? C : 1;
  int rcls[CR], rkey[CR];     // own nodes' class and key
  auto each = [&](auto&& body) { grid_each<C>(lo, steps, body); };

  // ---- phase 0 ----
  const size_t words = static_cast<size_t>(K) * 3 * nw;
  for (size_t w = blockIdx.x * kGridBlock + tid; w < words; w += stride) {
    pm[2 * w] = 0;
  }
  for (int x = blockIdx.x * kGridBlock + tid; x < 3 * K; x += stride) {
    cnt[x] = 0;
  }
  row_win_clear<3>(win);
  grid.sync();

  // ---- phase 1: classify, mark, count ----
  const int k_lo = lo / m;
  each([&](int j, int g) {
    int k = -1;
    int c = kNone, key = 0;
    if (g < hi) {
      k = g / m;
      c = classify(fmt, vis, pvp, nvp, pip, nip,
                   touched + static_cast<size_t>(k) * mb,
                   static_cast<size_t>(k) * m, g - k * m, &key);
      if (c != kNone) {
        mark(pm + static_cast<size_t>(k) * row_words(m), nw, c, key, m);
      }
    }
    rcls[j] = c;
    rkey[j] = key;
    const int v[3] = {c == 0, c == 1, c == 2};
    warp_row_add<3>(win, k_lo, cnt, k, v);
  });
  __syncthreads();
  row_win_flush<3>(win, k_lo, K, cnt);
  grid.sync();

  // ---- phase 2: popcount prefix over each chunk of a row-class ----
  for (int q = blockIdx.x; q < gs.chunks; q += gridDim.x) {
    const int rc = q / gs.per;
    const int wlo = (q - rc * gs.per) * gs.clen;
    const int whi = min(wlo + gs.clen, nw);
    uint32_t* base = pm + 2 * static_cast<size_t>(rc) * nw;
    int carry = 0;
    for (int b = wlo; b < whi; b += kGridBlock) {
      const int w = b + tid;
      const int x = w < whi ? __popc(base[2 * w]) : 0;
      int y, tot;
      BlockScan(scan_tmp).ExclusiveSum(x, y, tot);
      if (w < whi) base[2 * w + 1] = carry + y;
      carry += tot;
      __syncthreads();
    }
    if (tid == 0) chunk_sums[q] = carry;
  }
  grid.sync();

  // ---- phase 3: emit at the ranks, then the -1 fill ----
  scan_chunks<BlockScan>(chunk_sums, gs.chunks, cs, scan_tmp);
  each([&](int j, int g) {
    if (g >= hi) return;
    const int k = g / m;
    const int l = g - k * m;
    int c = rcls[j], key = rkey[j];
    if (C == 0) {
      c = classify(fmt, vis, pvp, nvp, pip, nip,
                   touched + static_cast<size_t>(k) * mb,
                   static_cast<size_t>(k) * m, l, &key);
    }
    if (c == kNone) return;
    const int row = (k * 3 + c) * gs.per;
    emit(pm + static_cast<size_t>(k) * row_words(m), nw, c, key, l, m, e_pad,
         static_cast<size_t>(k) * e_pad, rm_idx, ins_node, ins_idx, set_node,
         set_idx, [&](int w) { return cs[row + w / gs.clen] - cs[row]; });
  });
  const long long slots = static_cast<long long>(K) * e_pad;
  for (long long x = blockIdx.x * kGridBlock + tid; x < slots; x += stride) {
    const int k = static_cast<int>(x / e_pad);
    const int e = static_cast<int>(x - static_cast<long long>(k) * e_pad);
    int bits[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int row = (k * 3 + c) * gs.per;
      bits[c] = cs[row + gs.per] - cs[row];
    }
    fill(e, e_pad, bits, static_cast<size_t>(k) * e_pad, rm_idx, ins_node,
         ins_idx, set_node, set_idx);
  }
}

struct Args {
  int fmt;
  const int32_t* vis;
  const uint8_t* pv;
  const uint8_t* nv;
  const int32_t* pi;
  const int32_t* ni;
  const uint8_t* touched;
  int32_t* rm_idx;
  int32_t* ins_node;
  int32_t* ins_idx;
  int32_t* set_node;
  int32_t* set_idx;
  int32_t* cnt;
  int K, m, mb, e_pad;
  cudaStream_t stream;
};

template <int C>
int launch_warp(const Args& a) {
  const size_t wbytes = row_words(a.m) * 4;
  const int rows = static_cast<int>(
      std::min<size_t>(kWarpMaxRows, kSmemLimit / wbytes));
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = wbytes * rows;
  const cudaError_t e = opt_in_smem(es_warp_kernel<C>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = (a.K + rows - 1) / rows;
  es_warp_kernel<C><<<grid, 32 * rows, smem, a.stream>>>(
      a.fmt, a.vis, a.pv, a.nv, a.pi, a.ni, a.touched, a.rm_idx, a.ins_node,
      a.ins_idx, a.set_node, a.set_idx, a.cnt, a.K, a.m, a.mb, a.e_pad);
  return static_cast<int>(cudaGetLastError());
}

int launch_block(const Args& a, uint32_t* scratch) {
  const size_t bytes = row_words(a.m) * 4;
  const int use_smem = bytes <= static_cast<size_t>(kSmemLimit);
  if (!use_smem && scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = use_smem ? bytes : 0;
  const cudaError_t e = opt_in_smem(es_block_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  es_block_kernel<<<a.K, kBlock, smem, a.stream>>>(
      a.fmt, a.vis, a.pv, a.nv, a.pi, a.ni, a.touched, a.rm_idx, a.ins_node,
      a.ins_idx, a.set_node, a.set_idx, a.cnt, scratch, a.m, a.mb, a.e_pad,
      use_smem);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_grid_c(const Args& a, uint32_t* scratch, const GridShape& gs,
                  size_t smem) {
  return static_cast<int>(grid_launch(
      es_grid_kernel<C>, gs, smem, a.stream, a.fmt, a.vis, a.pv, a.nv, a.pi,
      a.ni, a.touched, a.rm_idx, a.ins_node, a.ins_idx, a.set_node,
      a.set_idx, a.cnt, scratch,
      reinterpret_cast<int32_t*>(scratch + a.K * row_words(a.m)), a.K, a.m,
      a.mb, a.e_pad, gs));
}

// The grid variant's launch: the grid from the card's residency, then
// the kernel that keeps gs.regs nodes a thread in registers (up to 4;
// past that it decodes them again).
int launch_grid(const Args& a, uint32_t* scratch) {
  if (scratch == nullptr || a.K > kGridMaxRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = (grid_chunk_words(3 * a.K) + 1) * sizeof(int32_t);
  GridShape gs;
  const cudaError_t e = grid_shape(
      smem, static_cast<long long>(a.K) * a.m, 3 * a.K, n_words(a.m), &gs,
      es_grid_kernel<0>, es_grid_kernel<1>, es_grid_kernel<2>,
      es_grid_kernel<4>);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (gs.regs <= 1) return launch_grid_c<1>(a, scratch, gs, smem);
  if (gs.regs <= 2) return launch_grid_c<2>(a, scratch, gs, smem);
  if (gs.regs <= 4) return launch_grid_c<4>(a, scratch, gs, smem);
  return launch_grid_c<0>(a, scratch, gs, smem);
}

}  // namespace

// Whether the block variant at width m keeps its bitmasks in shared
// memory; when it does not, the caller passes a global scratch of
// K * 6 * ceil(m/32) uint32 words.
extern "C" int edit_stream_block_uses_smem(int m) {
  return row_words(m) * 4 <= static_cast<size_t>(kSmemLimit);
}

// Words of the grid variant's scratch at (K, m): the bitmasks of
// K * 6 * ceil(m/32) uint32 and the chunk table.
extern "C" long long edit_stream_grid_scratch_words(int K, int m) {
  return static_cast<long long>(K) * row_words(m) + grid_chunk_words(3 * K);
}

// C entry point (bound with ctypes). variant 0: one warp per row; 1: one
// block per row; 2: one cooperative launch over the whole card. fmt 0: `vis` is the packed int32 [K, m] word plane;
// fmt 1: pv/nv are uint8 (bool) and pi/ni int32 [K, m] planes; fmt 2 (the
// wide format): `vis` is the int32 [K, m] prior word plane and `ni` the
// new word plane (pv, nv and pi are unused). touched is
// uint8 [K, mb] (mb = ceil(m / 8)). Outputs are int32 [K, e_pad] x 5 and
// [K, 3]; scratch is null unless the block variant needs it, and holds
// edit_stream_grid_scratch_words(K, m) words for the grid variant.
// Returns the CUDA error of the launch (0 on success).
extern "C" int edit_stream_launch(int variant, int fmt, const void* vis,
                                  const void* pv, const void* nv,
                                  const void* pi, const void* ni,
                                  const void* touched, void* rm_idx,
                                  void* ins_node, void* ins_idx,
                                  void* set_node, void* set_idx, void* cnt,
                                  void* scratch, int K, int m, int mb,
                                  int e_pad, void* stream) {
  if (K <= 0) return 0;
  const Args a{fmt,
               static_cast<const int32_t*>(vis),
               static_cast<const uint8_t*>(pv),
               static_cast<const uint8_t*>(nv),
               static_cast<const int32_t*>(pi),
               static_cast<const int32_t*>(ni),
               static_cast<const uint8_t*>(touched),
               static_cast<int32_t*>(rm_idx),
               static_cast<int32_t*>(ins_node),
               static_cast<int32_t*>(ins_idx),
               static_cast<int32_t*>(set_node),
               static_cast<int32_t*>(set_idx),
               static_cast<int32_t*>(cnt),
               K,
               m,
               mb,
               e_pad,
               static_cast<cudaStream_t>(stream)};
  if (variant == 1) return launch_block(a, static_cast<uint32_t*>(scratch));
  if (variant == 2) return launch_grid(a, static_cast<uint32_t*>(scratch));
  if (m <= 32) return launch_warp<1>(a);
  if (m <= 64) return launch_warp<2>(a);
  if (m <= 128) return launch_warp<4>(a);
  if (m <= 256) return launch_warp<8>(a);
  if (m <= 512) return launch_warp<16>(a);
  if (m <= 1024) return launch_warp<32>(a);
  return launch_warp<0>(a);
}
