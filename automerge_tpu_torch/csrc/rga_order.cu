// RGA document order of every dirty sequence object, in four variants.
//
// Replaces the TPU kernel in automerge_tpu/device/pallas_sequence.py:63-208
// (_make_kernel, _rga_pallas_padded, rga_order_batch_pallas). That kernel
// sends every gather and scatter through one-hot MXU matmuls over [m, m]
// tiles (O(m^2) per round) because the TPU has no fast gather, and leaves
// the child sort to XLA. On Hopper a gather is a plain indexed load, so
// every variant computes the plain version (sequence._rga_order_plain:
// sequence._child_sort, then sequence._order_from_sorted_plain) directly,
// with the same round count and the same sentinel slots:
//
//   per job row (n = m nodes; node 0 is the head):
//     0. sort: parent_adj = parent for valid non-head nodes, else n;
//        the stable sort of (parent_adj asc, elem desc, actor desc)
//     1. thread: p_sorted[s] = parent_adj[order[s]];
//        first_child[p_sorted[s]] = order[s] at each sort-segment start
//        (p == n is the sink), next_sibling[order[s]] = order[s+1] when
//        the next sorted node has the same parent, else -1;
//        next_sibling[0] = -1
//     2. climb: c[i] = (next_sibling[i] >= 0 || i == 0) ? i
//        : clamp(parent[i], 0, n-1); `rounds` pointer-doubling rounds
//        c = c[c]; succ[i] = first_child[i] >= 0 ? first_child[i]
//        : next_sibling[c[i]], -1 for invalid rows
//     3. rank: (n+1)-slot chain, slot n the terminator: nxt[i] = succ
//        or n, dist[i] = 1 (dist[n] = 0); `rounds` rounds of
//        dist += dist[nxt], nxt = nxt[nxt]; tree_pos = dist[0] - dist
//     4. scan: node_at_pos[tree_pos[i]] = i for on-chain nodes (valid,
//        tree_pos > 0) over a fill of n-1, position 0 set to 0 when any
//        node is off the chain; vis_ordered[p] = on_chain & visible at
//        node_at_pos[p]; an exclusive scan of it over positions;
//        vis_index[i] = rank at tree_pos[i] for visible on-chain nodes,
//        else -1; length = their count
//
// Bound on the H100: per call it must read K*m*(4+4+4+1+1) bytes and
// write K*m*12 + K*4 bytes. The work is O(m log m) dependent shared-memory
// loads per row (and O(m^2) compares for the narrow variant's sort), so at
// the main path's width (m = 64) the time is set by the latency of each
// row's chain of dependent steps, not by bytes or arithmetic: what a
// design can do is run many rows at once with few barriers between steps.
//
// Narrow variant (rga_narrow_kernel, m <= 512; the port dispatches
// m <= cuda_sequence.M_NARROW to it): one warp per job row and several
// rows per CTA, so a row's steps are separated only by __syncwarp. It
// takes the raw planes and does step 0 itself: node i's sorted slot is
// the number of nodes whose key (parent_adj, -elem, -actor, index) is
// lexicographically smaller, a full rank count (m^2/32 compares a lane)
// that equals the stable sort exactly, ties included. The compares are
// what the kernel spends most of its instructions on, so a row whose
// parent_adj and elem and actor spans fit packs (parent_adj, elem desc,
// actor desc) order-preservingly into one u32 (the main path's rows) or
// u64 word and breaks ties by index through the loop order, one integer
// compare a pair; other rows compare the full key as two u64 words. Each
// warp stages its row through its own slice of shared memory (16-byte
// loads where the row is aligned), keeps each lane's nodes (i = 32t +
// lane) in registers, ping-pongs the doubling planes, scans visibility
// with a ballot and a popcount per 32 positions and a carried offset,
// and writes every output once, coalesced. Nothing goes through global
// scratch.
//
// Delta mode (rga_delta_run, the same narrow kernel with an anchor
// plane): the delta orderer behind the incremental index update
// (sequence._rga_delta_order_batched; the JAX package's
// automerge_tpu/device/sequence.py:252-300). Slot 0 stands in for the
// whole existing tree and a child of it carries its anchor, the old tree
// position of its real parent; the sort key gains that anchor as a word
// between parent_adj and elem: (parent_adj asc, anchor_k asc, elem desc,
// actor desc, index asc), anchor_k = anchor for children of slot 0, else
// 0. An anchor reaches 2^22 - 1 and an elem is a full int32 on the wide
// mirror, so the packed keys take the anchor's span as one more field
// and fall back to the two-word full key (parent_adj, anchor_k) and
// (elem, actor) when the spans do not fit 63 bits. Only tree_pos is read
// by the caller, so the delta mode writes nothing else. Zero anchors give
// the rebuild's order, bit for bit.
//
// Subwarp variant of the delta mode (rga_subwarp_delta_kernel, m <= 32;
// the port dispatches m <= cuda_sequence.M_SUBWARP to it): a warm tick's
// delta rows are a few nodes wide (config 5's tick 2: 12,288 rows of 9),
// so one warp a row leaves 23 of its 32 lanes idle through every
// dependent step. This variant gives each row a group of W lanes (W the
// next power of two >= m, one node a lane) and packs 32 / W rows into a
// warp; the chain of dependent steps is the narrow kernel's, but each
// gather is a shuffle within the group, the span reductions are
// butterfly shuffles (or one reduction with the group's mask from 16
// lanes up), and only the two scatters go through shared memory.
//
// Wide variant (rga_wide_kernel, rows past 512 nodes that are not a few
// long ones; rga_wide_launch): one block of 1,024 threads a job row, from
// the raw planes, the child sort inside. It replaces the TPU kernel at
// pallas_sequence.py:165 (_rga_pallas_padded) together with the child
// sort the reference leaves to XLA (pallas_sequence.py:21-23, :182-200).
// What bounds it on the H100: a row's work is a chain of dependent steps
// (the sort's passes, 2 * ceil(log2 m) + 2 doubling rounds at most), each
// a sweep of shared-memory loads and a block barrier, so its time is set
// by the number of steps and the slots each sweeps, not by the
// K*m*(14 + 12) bytes it must move (the delta mode: K*m*(17 + 4)). The
// general engine pads every job row of a tick to the tick's widest row
// (a 6,144-node text makes every short list of the tick a 6,144-slot
// row), so what the design does is cut the steps and the slots:
//   - the child sort is a stable LSD radix sort in shared memory: the key
//     (parent_adj asc, anchor_k asc, elem desc, actor desc) taken one
//     field at a time over its span in the row, 8 bits a pass, each pass
//     a warp-chunked counting sort (__match_any_sync ranks, a block scan
//     of a [digit][warp] table): O(m) a pass, the passes set by the
//     spans' bits (the prepend case and 128-bit keys included), never a
//     rank count (the narrow kernel's O(m^2) one; 164M compares for a
//     12,799-node prepend row);
//   - the row is staged once with cp.async (valid first, to find the
//     extent; parent, elem, actor and anchor then; visible during the
//     sort), so every gather after it is a shared-memory load, and every
//     output is written once, coalesced;
//   - the work covers the row's extent E (one past its last valid node),
//     not its padded width, where a block vote shows every valid node's
//     parent to be the head or an earlier valid node: then no valid
//     node's climb or successor leaves [0, E), the padding's outputs are
//     fixed (tree_pos d0 - 1, vis_index -1, node_at_pos n - 1) and are
//     written directly. Any other row (a valid node under an invalid,
//     later or out-of-range parent, whose climb may walk the padding's
//     sibling links or a cycle) works on the whole width, exactly as the
//     plain version does;
//   - the climb and the ranking stop after the first round in which no
//     value changed (a fixed point stays one, so no output changes), at
//     most `rounds` rounds (a cycle among garbage nodes runs them all);
//   - the planes take 20 bytes a node and the valid and visible bytes
//     (the delta mode 24 and 1), staged planes reused as work planes once
//     the sort has read them, up to 215,040 bytes beside a 16 KB count
//     table (m <= 9,771; the delta mode 8,599); wider rows run the same
//     code on a global scratch of four planes a row, L2-resident.
//
// Grid variant (rga_grid_kernel, after the same sort): a batch of one or
// a few long rows (a long text, a replayed editing trace) would run the
// wide variant on one block per row, so on a few of the card's 132 SMs,
// each block walking its row through 2*rounds dependent sweeps. This
// variant spreads the K*(m+1) slots over every resident CTA and runs
// steps 1-4 as grid-wide phases of ONE cooperative launch, a grid barrier
// between phases (csrc/grid.cuh): 2*rounds + 4 phases, the climb's last
// round fused with the successor and the ranking's last round with
// tree_pos and the node_at_pos scatter. Its time is set by the barriers
// (about 1.1-1.7 us each on an H100, more with more CTAs) and each
// round's one dependent L2 load, not by bytes: the planes (5 * 4 bytes a
// slot) stay in the 50 MB L2.

#include <cstddef>
#include <algorithm>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

#include "grid.cuh"
#include "smem.cuh"

namespace {

constexpr int kSmemLimit = 200 * 1024;

__host__ __device__ inline size_t plane_words(int m) {
  return static_cast<size_t>(m) + 1;
}

// ---- narrow variant: one warp per job row --------------------------------

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNarrowMaxM = 512;
constexpr int kNarrowMaxRows = 8;       // job rows (warps) per CTA

__host__ __device__ inline size_t round16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

// Bytes of one warp's slice: the staged visible and valid bytes (16 each
// rounded up), two u64 sort keys, parent_adj and the sorted order per
// node, then four planes of m+1 words; a multiple of 16.
__host__ __device__ inline size_t narrow_warp_bytes(int m) {
  const size_t n = static_cast<size_t>(m);
  return round16(2 * round16(n) + n * (8 + 8 + 4 + 4) +
                 4 * plane_words(m) * 4);
}

// The full sort key as two u64 words, ordered as (parent_adj asc,
// anchor_k asc) then (elem desc, actor desc), with the index as the last
// tie-break: the signed values map order-preservingly to unsigned
// (x ^ 0x80000000), descending ones are complemented, so no negation can
// wrap.
__device__ __forceinline__ uint64_t key_hi(int padj, int ak) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(padj) ^ 0x80000000u)
          << 32) |
         static_cast<uint64_t>(static_cast<uint32_t>(ak) ^ 0x80000000u);
}
__device__ __forceinline__ uint64_t key_lo(int elem, int actor) {
  return (static_cast<uint64_t>(~(static_cast<uint32_t>(elem) ^
                                  0x80000000u))
          << 32) |
         static_cast<uint64_t>(~(static_cast<uint32_t>(actor) ^ 0x80000000u));
}

// (parent_adj, anchor_k - kmin, emax - elem, amax - actor) packed into
// fields of (the row's parent_adj bits), bk, be and ba bits.
template <typename Key>
__device__ __forceinline__ Key pack_key(int padj, int ak, int elem,
                                        int actor, int kmin, int emax,
                                        int amax, int bk, int be, int ba) {
  return (static_cast<Key>(padj) << (bk + be + ba)) |
         (static_cast<Key>(static_cast<uint32_t>(ak) -
                           static_cast<uint32_t>(kmin))
          << (be + ba)) |
         (static_cast<Key>(static_cast<uint32_t>(emax) -
                           static_cast<uint32_t>(elem))
          << ba) |
         static_cast<Key>(static_cast<uint32_t>(amax) -
                          static_cast<uint32_t>(actor));
}

// slot[t] = number of nodes whose full key is smaller than node
// i = 32t + lane's (128-bit compares, then the index: any values).
template <int C>
__device__ __forceinline__ void rank_full(const uint64_t* khi,
                                          const uint64_t* klo, int n,
                                          int lane, const uint64_t (&hi)[C],
                                          const uint64_t (&lo)[C],
                                          int (&slot)[C]) {
  for (int j = 0; j < n; ++j) {
    const uint64_t hj = khi[j];
    const uint64_t lj = klo[j];
#pragma unroll
    for (int t = 0; t < C; ++t) {
      slot[t] += (hj < hi[t]) |
                 ((hj == hi[t]) &
                  ((lj < lo[t]) | ((lj == lo[t]) & (j < 32 * t + lane))));
    }
  }
}

// The same count from one packed key per node (u32 or u64) that orders
// (parent_adj, elem desc, actor desc) but not the index: node j sorts
// before node i when key_j < key_i, or key_j == key_i and j < i, that is
// key_j < key_i + (j < i) (keys stay below the type's top bit, so the +1
// cannot wrap). j runs in chunks of 32, so whether j < i is known at
// compile time except in a lane's own chunk.
template <int C, typename Key>
__device__ __forceinline__ void rank_packed(const Key* key, int n, int lane,
                                            const Key (&k)[C],
                                            int (&slot)[C]) {
  Key k1[C];
#pragma unroll
  for (int t = 0; t < C; ++t) k1[t] = k[t] + 1;
#pragma unroll
  for (int jc = 0; jc < C; ++jc) {
    const int jn = min(32, n - 32 * jc);
#pragma unroll 4
    for (int jj = 0; jj < jn; ++jj) {
      const Key kj = key[32 * jc + jj];
#pragma unroll
      for (int t = 0; t < C; ++t) {
        const Key kt = jc < t ? k1[t]
                       : jc > t ? k[t] : (jj < lane ? k1[t] : k[t]);
        slot[t] += kj < kt;
      }
    }
  }
}

// Copy a row of n words (bytes) from global into shared memory: 16-byte
// loads when the row starts 16-byte aligned, single loads otherwise and
// for the tail.
__device__ __forceinline__ void stage_words(const int32_t* __restrict__ g,
                                            int32_t* s, int n, int lane) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    const int n4 = n >> 2;
    const int4* g4 = reinterpret_cast<const int4*>(g);
    for (int q = lane; q < n4; q += 32) {
      const int4 v = __ldg(g4 + q);
      s[4 * q] = v.x;
      s[4 * q + 1] = v.y;
      s[4 * q + 2] = v.z;
      s[4 * q + 3] = v.w;
    }
    done = 4 * n4;
  }
  for (int i = done + lane; i < n; i += 32) s[i] = __ldg(g + i);
}

__device__ __forceinline__ void stage_bytes(const uint8_t* __restrict__ g,
                                            uint8_t* s, int n, int lane) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    const int n16 = n >> 4;
    const uint4* g4 = reinterpret_cast<const uint4*>(g);
    uint32_t* s4 = reinterpret_cast<uint32_t*>(s);   // s is 16-byte aligned
    for (int q = lane; q < n16; q += 32) {
      const uint4 v = __ldg(g4 + q);
      s4[4 * q] = v.x;
      s4[4 * q + 1] = v.y;
      s4[4 * q + 2] = v.z;
      s4[4 * q + 3] = v.w;
    }
    done = 16 * n16;
  }
  for (int i = done + lane; i < n; i += 32) s[i] = __ldg(g + i);
}

// C = ceil(m / 32) rounded up to a power of two: each lane owns nodes
// i = 32t + lane, t < C, and keeps their values in registers.
template <int C>
__global__ void __launch_bounds__(32 * kNarrowMaxRows)
rga_narrow_kernel(const int32_t* __restrict__ parent,
                  const int32_t* __restrict__ elem,
                  const int32_t* __restrict__ actor,
                  const int32_t* __restrict__ anchor,
                  const uint8_t* __restrict__ visible,
                  const uint8_t* __restrict__ valid,
                  int32_t* __restrict__ tree_pos,
                  int32_t* __restrict__ vis_index,
                  int32_t* __restrict__ node_at_pos,
                  int32_t* __restrict__ length, int K, int m, int rounds,
                  int warp_bytes) {
  extern __shared__ __align__(16) unsigned char narrow_smem[];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int k = blockIdx.x * (blockDim.x >> 5) + wid;
  if (k >= K) return;
  const int n = m;
  const int W = n + 1;

  // this warp's slice: staged bytes, keys, parent_adj, order, four
  // planes (P0..P3)
  unsigned char* wb = narrow_smem + static_cast<size_t>(wid) * warp_bytes;
  uint8_t* vis_s = wb;
  uint8_t* val_s = vis_s + round16(n);
  uint64_t* khi = reinterpret_cast<uint64_t*>(val_s + round16(n));
  uint64_t* klo = khi + n;
  int32_t* pa = reinterpret_cast<int32_t*>(klo + n);
  int32_t* ord = pa + n;
  int32_t* P0 = ord + n;
  int32_t* P1 = P0 + W;
  int32_t* P2 = P1 + W;
  int32_t* P3 = P2 + W;
  const size_t off = static_cast<size_t>(k) * m;

  // ---- stage the row: parent -> P2, elem -> P0, actor -> P1 ----
  stage_words(parent + off, P2, n, lane);
  stage_words(elem + off, P0, n, lane);
  stage_words(actor + off, P1, n, lane);
  stage_bytes(visible + off, vis_s, n, lane);
  stage_bytes(valid + off, val_s, n, lane);
  __syncwarp();

  int par[C], padj[C], ak[C], el[C], ac[C];
  bool vis[C], val[C];
  int pmin = INT32_MAX, pmax = INT32_MIN, emin = INT32_MAX;
  int emax = INT32_MIN, amin = INT32_MAX, amax = INT32_MIN;
  int kmin = INT32_MAX, kmax = INT32_MIN;
#pragma unroll
  for (int t = 0; t < C; ++t) {
    const int i = 32 * t + lane;
    par[t] = padj[t] = ak[t] = el[t] = ac[t] = 0;
    vis[t] = val[t] = false;
    if (i < n) {
      par[t] = P2[i];
      el[t] = P0[i];
      ac[t] = P1[i];
      vis[t] = vis_s[i] != 0;
      val[t] = val_s[i] != 0;
      // the head (node 0) is nobody's child: bucket it with the padding
      padj[t] = (val[t] && i != 0) ? par[t] : n;
      pa[i] = padj[t];
      // delta mode: a child of slot 0 sorts by its anchor first
      if (anchor != nullptr && padj[t] == 0) ak[t] = __ldg(anchor + off + i);
      pmin = min(pmin, padj[t]);
      pmax = max(pmax, padj[t]);
      kmin = min(kmin, ak[t]);
      kmax = max(kmax, ak[t]);
      emin = min(emin, el[t]);
      emax = max(emax, el[t]);
      amin = min(amin, ac[t]);
      amax = max(amax, ac[t]);
    }
  }
  pmin = __reduce_min_sync(kFull, pmin);
  pmax = __reduce_max_sync(kFull, pmax);
  kmin = __reduce_min_sync(kFull, kmin);
  kmax = __reduce_max_sync(kFull, kmax);
  emin = __reduce_min_sync(kFull, emin);
  emax = __reduce_max_sync(kFull, emax);
  amin = __reduce_min_sync(kFull, amin);
  amax = __reduce_max_sync(kFull, amax);

  // ---- 0. child sort: slot = number of nodes that sort before ----
  // The row's key packs order-preservingly into parent_adj << (bk + be +
  // ba) | (anchor_k - kmin) << (be + ba) | (emax - elem) << ba | (amax -
  // actor), where bk, be and ba are the bits of the anchor, elem and
  // actor spans (bk = 0 without an anchor plane): into a u32 when that
  // needs at most 31 bits (the main path's rows), a u64 up to 63, else
  // the full key.
  const int bk = 32 - __clz(static_cast<uint32_t>(kmax) -
                            static_cast<uint32_t>(kmin));
  const int ba = 32 - __clz(static_cast<uint32_t>(amax) -
                            static_cast<uint32_t>(amin));
  const int be = 32 - __clz(static_cast<uint32_t>(emax) -
                            static_cast<uint32_t>(emin));
  const int bits = pmin < 0 ? 64 : 32 - __clz(pmax) + bk + be + ba;
  int slot[C];
#pragma unroll
  for (int t = 0; t < C; ++t) slot[t] = 0;
  if (bits <= 31) {
    uint32_t key[C];
#pragma unroll
    for (int t = 0; t < C; ++t) {
      const int i = 32 * t + lane;
      key[t] = pack_key<uint32_t>(padj[t], ak[t], el[t], ac[t], kmin, emax,
                                  amax, bk, be, ba);
      if (i < n) reinterpret_cast<uint32_t*>(khi)[i] = key[t];
    }
    __syncwarp();
    rank_packed<C>(reinterpret_cast<const uint32_t*>(khi), n, lane, key,
                   slot);
  } else if (bits <= 63) {
    uint64_t key[C];
#pragma unroll
    for (int t = 0; t < C; ++t) {
      const int i = 32 * t + lane;
      key[t] = pack_key<uint64_t>(padj[t], ak[t], el[t], ac[t], kmin, emax,
                                  amax, bk, be, ba);
      if (i < n) khi[i] = key[t];
    }
    __syncwarp();
    rank_packed<C>(static_cast<const uint64_t*>(khi), n, lane, key, slot);
  } else {
    uint64_t hi[C], lo[C];
#pragma unroll
    for (int t = 0; t < C; ++t) {
      const int i = 32 * t + lane;
      hi[t] = key_hi(padj[t], ak[t]);
      lo[t] = key_lo(el[t], ac[t]);
      if (i < n) {
        khi[i] = hi[t];
        klo[i] = lo[t];
      }
    }
    __syncwarp();
    rank_full<C>(khi, klo, n, lane, hi, lo, slot);
  }
#pragma unroll
  for (int t = 0; t < C; ++t) {
    const int i = 32 * t + lane;
    if (i < n) ord[slot[t]] = i;
  }
  for (int i = lane; i < W; i += 32) P0[i] = -1;     // first_child
  __syncwarp();

  // ---- 1. thread the tree: P0 = first_child, P1 = next_sibling ----
  int ns[C];
#pragma unroll
  for (int t = 0; t < C; ++t) {
    const int i = 32 * t + lane;
    ns[t] = -1;
    if (i < n) {
      const int p = padj[t];
      const int s = slot[t];
      const bool start = s == 0 || pa[ord[s - 1]] != p;
      if (start && p >= 0 && p < n) P0[p] = i;
      if (i != 0 && s + 1 < n) {   // head and padding share a bucket
        const int o2 = ord[s + 1];
        if (pa[o2] == p) ns[t] = o2;
      }
      P1[i] = ns[t];
    }
  }

  // ---- 2. climb to the nearest ancestor-or-self with a sibling ----
  int c[C];
#pragma unroll
  for (int t = 0; t < C; ++t) {
    const int i = 32 * t + lane;
    c[t] = 0;
    if (i < n) {
      c[t] = (ns[t] >= 0 || i == 0) ? i : min(max(par[t], 0), n - 1);
      P2[i] = c[t];
    }
  }
  __syncwarp();
  int32_t* cc = P2;
  int32_t* cn = P3;
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int t = 0; t < C; ++t) {
      const int i = 32 * t + lane;
      if (i < n) {
        c[t] = cc[c[t]];
        cn[i] = c[t];
      }
    }
    __syncwarp();
    int32_t* tmp = cc;
    cc = cn;
    cn = tmp;
  }
  // successor chain: nxt = succ or n
  int nx[C];
#pragma unroll
  for (int t = 0; t < C; ++t) {
    const int i = 32 * t + lane;
    nx[t] = n;
    if (i < n && val[t]) {
      const int fc = P0[i];
      const int succ = fc >= 0 ? fc : P1[c[t]];
      nx[t] = succ >= 0 ? succ : n;
    }
  }
  __syncwarp();           // every plane is free from here

  // ---- 3. list-rank the chain: dist in P0/P1, nxt in P2/P3 ----
  int32_t* dc = P0;
  int32_t* dn = P1;
  int32_t* xc = P2;
  int32_t* xn = P3;
  int d[C];
#pragma unroll
  for (int t = 0; t < C; ++t) {
    const int i = 32 * t + lane;
    d[t] = 1;
    if (i < n) {
      dc[i] = 1;
      xc[i] = nx[t];
    }
  }
  if (lane == 0) {        // the terminator slot never changes
    dc[n] = dn[n] = 0;
    xc[n] = xn[n] = n;
  }
  __syncwarp();
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int t = 0; t < C; ++t) {
      const int i = 32 * t + lane;
      if (i < n) {
        const int j = nx[t];
        const int dj = dc[j];
        const int xj = xc[j];
        d[t] += dj;
        nx[t] = xj;
        dn[i] = d[t];
        xn[i] = xj;
      }
    }
    __syncwarp();
    int32_t* tmp = dc;
    dc = dn;
    dn = tmp;
    tmp = xc;
    xc = xn;
    xn = tmp;
  }
  const int d0 = __shfl_sync(kFull, d[0], 0);   // node 0 is lane 0's
  int tp[C];
  bool shown[C];
  bool off_chain = false;
#pragma unroll
  for (int t = 0; t < C; ++t) {
    const int i = 32 * t + lane;
    tp[t] = d0 - d[t];
    shown[t] = false;
    if (i < n) {
      tree_pos[off + i] = tp[t];
      const bool on = val[t] && tp[t] > 0;
      shown[t] = on && vis[t];
      off_chain |= !on;
    }
  }
  if (anchor != nullptr) return;   // delta mode: tree_pos is its output
  off_chain = __any_sync(kFull, off_chain);

  // ---- 4. node_at_pos in P0, shown flags in P1, ranks in P2 ----
  int32_t* nap = P0;
  int32_t* sh = P1;
  int32_t* vr = P2;
  for (int p = lane; p < W; p += 32) {
    nap[p] = (p == 0 && off_chain) ? 0 : n - 1;
  }
#pragma unroll
  for (int t = 0; t < C; ++t) {
    const int i = 32 * t + lane;
    if (i < n) sh[i] = shown[t];
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < C; ++t) {
    const int i = 32 * t + lane;
    if (i < n && val[t] && tp[t] > 0 && tp[t] <= n) nap[tp[t]] = i;
  }
  __syncwarp();
  // exclusive scan of shown[node_at_pos[p]] over positions p = 32t + lane
  const unsigned below = (1u << lane) - 1u;
  int carry = 0;
#pragma unroll
  for (int t = 0; t < C; ++t) {
    const int p = 32 * t + lane;
    bool v = false;
    if (p < n) {
      const int j = nap[p];
      node_at_pos[off + p] = j;
      v = sh[j] != 0;
    }
    const unsigned b = __ballot_sync(kFull, v);
    if (p < n) vr[p] = carry + __popc(b & below);
    carry += __popc(b);
  }
  __syncwarp();
  int total = 0;
#pragma unroll
  for (int t = 0; t < C; ++t) {
    const int i = 32 * t + lane;
    if (i < n) {
      vis_index[off + i] = shown[t] ? vr[min(max(tp[t], 0), n - 1)] : -1;
    }
    total += __popc(__ballot_sync(kFull, shown[t]));
  }
  if (lane == 0) length[k] = total;
}

template <int C>
int launch_narrow(const int32_t* parent, const int32_t* elem,
                  const int32_t* actor, const int32_t* anchor,
                  const uint8_t* visible,
                  const uint8_t* valid, int32_t* tree_pos,
                  int32_t* vis_index, int32_t* node_at_pos, int32_t* length,
                  int K, int m, int rounds, cudaStream_t stream) {
  const size_t wbytes = narrow_warp_bytes(m);
  const int rows = static_cast<int>(
      std::min<size_t>(kNarrowMaxRows, kSmemLimit / wbytes));
  const size_t smem = wbytes * rows;
  const cudaError_t e = opt_in_smem(rga_narrow_kernel<C>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = (K + rows - 1) / rows;
  rga_narrow_kernel<C><<<grid, 32 * rows, smem, stream>>>(
      parent, elem, actor, anchor, visible, valid, tree_pos, vis_index,
      node_at_pos, length, K, m, rounds, static_cast<int>(wbytes));
  return static_cast<int>(cudaGetLastError());
}

// The narrow variant's dispatch on C = ceil(m / 32), rounded up to a
// power of two; anchor null is the rebuild's order.
int narrow_dispatch(const void* parent, const void* elem, const void* actor,
                    const void* anchor, const void* visible,
                    const void* valid, void* tree_pos, void* vis_index,
                    void* node_at_pos, void* length, int K, int m,
                    int rounds, void* stream) {
  if (K <= 0) return 0;
  if (m < 1 || m > kNarrowMaxM) return static_cast<int>(cudaErrorInvalidValue);
  auto args = [&](auto launcher) {
    return launcher(static_cast<const int32_t*>(parent),
                    static_cast<const int32_t*>(elem),
                    static_cast<const int32_t*>(actor),
                    static_cast<const int32_t*>(anchor),
                    static_cast<const uint8_t*>(visible),
                    static_cast<const uint8_t*>(valid),
                    static_cast<int32_t*>(tree_pos),
                    static_cast<int32_t*>(vis_index),
                    static_cast<int32_t*>(node_at_pos),
                    static_cast<int32_t*>(length), K, m, rounds,
                    static_cast<cudaStream_t>(stream));
  };
  if (m <= 32) return args(launch_narrow<1>);
  if (m <= 64) return args(launch_narrow<2>);
  if (m <= 128) return args(launch_narrow<4>);
  if (m <= 256) return args(launch_narrow<8>);
  return args(launch_narrow<16>);
}


// ---- subwarp variant: several short delta rows a warp ----------------------

constexpr int kSubwarpWarps = 8;      // the most warps a CTA takes
constexpr int kSubwarpMaxM = 32;  // the widest row (cuda_sequence.M_SUBWARP)

// The minimum (or maximum) of v over the lane group of W lanes: butterfly
// shuffles up to 8 lanes a group, where a reduction with the group's mask
// would be issued once for each of the warp's 4 to 32 groups; one
// reduction with the group's mask at 16 and 32.
template <int W, bool MAX>
__device__ __forceinline__ int group_reduce(int v, unsigned gmask) {
  if constexpr (W >= 16) {
    return MAX ? __reduce_max_sync(gmask, v) : __reduce_min_sync(gmask, v);
  } else {
#pragma unroll
    for (int o = W / 2; o > 0; o >>= 1) {
      const int u = __shfl_xor_sync(kFull, v, o, W);
      v = MAX ? max(v, u) : min(v, u);
    }
    return v;
  }
}

// The delta mode's order for rows of m <= W nodes, W a power of two:
// 32 / W rows a warp, one lane group of W lanes a row, lane i of a group
// holding node i in registers. The narrow kernel's steps with the same
// keys and round counts, but every gather of a node's value is a
// shuffle within the group (width W), so the doubling rounds touch no
// shared memory and need no __syncwarp; only the two scatters (the
// sorted order and each parent's first child) go through a per-row
// shared slice of W words each. The rank count is m compares a lane,
// one shuffled key each. A CTA takes up to kSubwarpWarps warps, fewer
// when the rows would leave the card with fewer than two CTAs an SM.
// Writes tree_pos only.
template <int W>
__global__ void __launch_bounds__(32 * kSubwarpWarps)
rga_subwarp_delta_kernel(const int32_t* __restrict__ parent,
                         const int32_t* __restrict__ anchor,
                         const int32_t* __restrict__ elem,
                         const int32_t* __restrict__ actor,
                         const uint8_t* __restrict__ valid,
                         int32_t* __restrict__ tree_pos, int K, int m,
                         int rounds) {
  constexpr int R = 32 / W;           // rows a warp
  __shared__ int s_ord[kSubwarpWarps][32];
  __shared__ int s_fc[kSubwarpWarps][32];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int base = lane & ~(W - 1);   // the group's first lane
  const int i = lane - base;          // the lane's node
  const unsigned gmask =
      W == 32 ? kFull : (((1u << (W & 31)) - 1u) << base);
  const long long k0 =
      (static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + wid) * R;
  if (k0 >= K) return;                // whole warps only
  const long long k = k0 + lane / W;
  const int n = m;
  // lanes past the row's width or past the last row hold padding and
  // take part in every shuffle
  const bool live = k < K && i < n;
  const size_t off = static_cast<size_t>(k) * m + i;
  int par = 0, padj = n, ak = 0, el = 0, ac = 0;
  bool val = false;
  if (live) {
    par = __ldg(parent + off);
    el = __ldg(elem + off);
    ac = __ldg(actor + off);
    val = __ldg(valid + off) != 0;
    padj = (val && i != 0) ? par : n;
    // a child of slot 0 sorts by its anchor first
    if (padj == 0) ak = __ldg(anchor + off);
  }
  const int pmin = group_reduce<W, false>(live ? padj : INT32_MAX, gmask);
  const int pmax = group_reduce<W, true>(live ? padj : INT32_MIN, gmask);
  const int kmin = group_reduce<W, false>(live ? ak : INT32_MAX, gmask);
  const int kmax = group_reduce<W, true>(live ? ak : INT32_MIN, gmask);
  const int emin = group_reduce<W, false>(live ? el : INT32_MAX, gmask);
  const int emax = group_reduce<W, true>(live ? el : INT32_MIN, gmask);
  const int amin = group_reduce<W, false>(live ? ac : INT32_MAX, gmask);
  const int amax = group_reduce<W, true>(live ? ac : INT32_MIN, gmask);

  // ---- 0. child sort: slot = number of nodes that sort before ----
  const int bk = 32 - __clz(static_cast<uint32_t>(kmax) -
                            static_cast<uint32_t>(kmin));
  const int ba = 32 - __clz(static_cast<uint32_t>(amax) -
                            static_cast<uint32_t>(amin));
  const int be = 32 - __clz(static_cast<uint32_t>(emax) -
                            static_cast<uint32_t>(emin));
  // a group's key path follows its own row's spans (bits <= 31: one u32,
  // <= 63: one u64, else the full key as two u64 words); the shuffles
  // take the full mask, so every lane runs the u32 shuffle and, where
  // any group of the warp needs them, the wider ones (n is the same for
  // every row)
  const int bits = pmin < 0 ? 64 : 32 - __clz(pmax) + bk + be + ba;
  const int mode = bits <= 31 ? 0 : bits <= 63 ? 1 : 2;
  const uint32_t k32 = mode == 0
      ? pack_key<uint32_t>(padj, ak, el, ac, kmin, emax, amax, bk, be, ba)
      : 0u;
  const uint64_t k64 = mode == 1
      ? pack_key<uint64_t>(padj, ak, el, ac, kmin, emax, amax, bk, be, ba)
      : 0ull;
  const uint64_t hi = key_hi(padj, ak);
  const uint64_t lo = key_lo(el, ac);
  const bool any_64 = __any_sync(kFull, mode == 1);
  const bool any_wide = __any_sync(kFull, mode == 2);
  int slot = 0;
  for (int j = 0; j < n; ++j) {
    // node j sorts before node i when key_j < key_i + (j < i): the keys
    // stay below their type's top bit, so the +1 cannot wrap
    const bool before = j < i;
    const uint32_t j32 = __shfl_sync(kFull, k32, j, W);
    if (mode == 0) slot += j32 < k32 + static_cast<uint32_t>(before);
    if (any_64) {
      const uint64_t j64 = __shfl_sync(kFull, k64, j, W);
      if (mode == 1) slot += j64 < k64 + static_cast<uint64_t>(before);
    }
    if (any_wide) {
      const uint64_t hj = __shfl_sync(kFull, hi, j, W);
      const uint64_t lj = __shfl_sync(kFull, lo, j, W);
      if (mode == 2) {
        slot += (hj < hi) | ((hj == hi) & ((lj < lo) |
                                           ((lj == lo) & before)));
      }
    }
  }
  int* ord = s_ord[wid] + base;
  int* fc = s_fc[wid] + base;
  fc[i] = -1;
  if (live) ord[slot] = i;
  __syncwarp();

  // ---- 1. thread the tree: first child (shared), next sibling ----
  const int o_prev = live && slot > 0 ? ord[slot - 1] : 0;
  const int o_next = live && slot + 1 < n ? ord[slot + 1] : 0;
  const int pa_prev = __shfl_sync(kFull, padj, o_prev, W);
  const int pa_next = __shfl_sync(kFull, padj, o_next, W);
  int ns = -1;
  if (live) {
    const bool start = slot == 0 || pa_prev != padj;
    if (start && padj >= 0 && padj < n) fc[padj] = i;
    // head and padding share a bucket
    if (i != 0 && slot + 1 < n && pa_next == padj) ns = o_next;
  }
  __syncwarp();
  const int first = fc[i];

  // ---- 2. climb to the nearest ancestor-or-self with a sibling ----
  int c = (ns >= 0 || i == 0 || !live) ? i : min(max(par, 0), n - 1);
  for (int r = 0; r < rounds; ++r) c = __shfl_sync(kFull, c, c, W);
  const int ns_c = __shfl_sync(kFull, ns, c, W);
  int nx = n;                          // successor, or n the terminator
  if (live && val) {
    const int succ = first >= 0 ? first : ns_c;
    nx = succ >= 0 ? succ : n;
  }

  // ---- 3. list-rank the chain (the terminator n: distance 0) ----
  int d = 1;
  for (int r = 0; r < rounds; ++r) {
    const int dj = __shfl_sync(kFull, d, nx, W);
    const int xj = __shfl_sync(kFull, nx, nx, W);
    if (nx != n) {
      d += dj;
      nx = xj;
    }
  }
  const int d0 = __shfl_sync(kFull, d, 0, W);
  if (live) tree_pos[off] = d0 - d;
}

template <int W>
int launch_subwarp(const int32_t* parent, const int32_t* anchor,
                   const int32_t* elem, const int32_t* actor,
                   const uint8_t* valid, int32_t* tree_pos, int K, int m,
                   int rounds, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long warps = (static_cast<long long>(K) + 32 / W - 1) / (32 / W);
  int wpc = kSubwarpWarps;
  while (wpc > 1 && warps < 2LL * sms * wpc) wpc >>= 1;
  const long long grid = (warps + wpc - 1) / wpc;
  rga_subwarp_delta_kernel<W><<<static_cast<unsigned>(grid), 32 * wpc, 0,
                                stream>>>(parent, anchor, elem, actor, valid,
                                          tree_pos, K, m, rounds);
  return static_cast<int>(cudaGetLastError());
}

// The subwarp variant's dispatch on W, the next power of two >= m.
int subwarp_dispatch(const int32_t* parent, const int32_t* anchor,
                     const int32_t* elem, const int32_t* actor,
                     const uint8_t* valid, int32_t* tree_pos, int K, int m,
                     int rounds, cudaStream_t stream) {
  if (m < 1 || m > kSubwarpMaxM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto go = [&](auto launcher) {
    return launcher(parent, anchor, elem, actor, valid, tree_pos, K, m,
                    rounds, stream);
  };
  if (m <= 1) return go(launch_subwarp<1>);
  if (m <= 2) return go(launch_subwarp<2>);
  if (m <= 4) return go(launch_subwarp<4>);
  if (m <= 8) return go(launch_subwarp<8>);
  if (m <= 16) return go(launch_subwarp<16>);
  return go(launch_subwarp<32>);
}


// ---- wide variant: one block a row, the child sort inside ---------------

constexpr int kWideBlock = 1024;
constexpr int kWideWarps = kWideBlock / 32;
constexpr int kRadixBits = 8;                        // one digit a pass
constexpr int kCountEntries = (1 << kRadixBits) * kWideWarps;
constexpr int kScanItems = kCountEntries / kWideBlock;
// the H100's shared memory a block can opt into, and the part of it the
// shared-memory variant's static storage (count table, block scan,
// scalars) may take; the rest holds the row's planes
constexpr size_t kWideSmemTotal = 232448;
constexpr size_t kWideStatic = 17 * 1024;
constexpr size_t kWideDynLimit = kWideSmemTotal - kWideStatic;

// Words of one plane of the wide variant: m + 1 (the terminator slot)
// rounded up to four, so that every plane starts 16-byte aligned.
__host__ __device__ inline size_t wide_words(int m) {
  return (static_cast<size_t>(m) + 4) & ~static_cast<size_t>(3);
}

// Dynamic shared memory of the shared-memory variant at width m: the
// staged parent, elem and actor planes (and anchor in the delta mode),
// the two index planes of the sort, and the valid bytes (and visible in
// the order mode). The index planes and the staged planes, once the sort
// has read them, are the threading, doubling and scan planes.
__host__ __device__ inline size_t wide_smem_bytes(int m, bool delta) {
  return (delta ? 6 : 5) * 4 * wide_words(m) +
         (delta ? 1 : 2) * round16(static_cast<size_t>(m));
}

template <bool SMEM>
struct WideShared {
  // a count needs 16 bits while the row fits shared memory (m < 65,536)
  using Count = typename std::conditional<SMEM, uint16_t, uint32_t>::type;
  using BlockScan =
      cub::BlockScan<int, kWideBlock, cub::BLOCK_SCAN_WARP_SCANS>;
  __align__(16) Count cnt[kCountEntries];   // [digit][warp], digit-major
  typename BlockScan::TempStorage scan;
  int last;                                  // the last valid node
  int lo[4], hi[4];      // span of each key field: parent_adj, anchor_k,
                         // elem, actor
  int shown;
};
static_assert(sizeof(WideShared<true>) <= kWideStatic,
              "the wide variant's static shared memory passes its reserve");

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(s))),
               "l"(g));
}
__device__ __forceinline__ void cp_async4(void* s, const void* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(s))),
               "l"(g));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start asynchronous copies of words [0, cnt) of a row of n words into
// shared memory (16-byte copies where the row starts 16-byte aligned, 4
// bytes otherwise and for the tail); the caller commits and waits.
__device__ __forceinline__ void stage_async(int32_t* s,
                                            const int32_t* __restrict__ g,
                                            int cnt, int n) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    const int q4 = min((cnt + 3) >> 2, n >> 2);
    for (int q = threadIdx.x; q < q4; q += kWideBlock) {
      cp_async16(s + 4 * q, g + 4 * q);
    }
    done = 4 * q4;
  }
  for (int i = done + threadIdx.x; i < cnt; i += kWideBlock) {
    cp_async4(s + i, g + i);
  }
}

// The same for bytes; a row that does not start 16-byte aligned, and the
// tail, are copied with plain loads.
__device__ __forceinline__ void stage_async_bytes(
    uint8_t* s, const uint8_t* __restrict__ g, int cnt, int n) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    const int q16 = min((cnt + 15) >> 4, n >> 4);
    for (int q = threadIdx.x; q < q16; q += kWideBlock) {
      cp_async16(s + 16 * q, g + 16 * q);
    }
    done = 16 * q16;
  }
  for (int i = done + threadIdx.x; i < cnt; i += kWideBlock) s[i] = g[i];
}

// The exclusive scan of the count table's first L entries in place,
// digit-major: entry (d, w) becomes the sorted position of the first node
// of digit d in warp w's chunk.
template <bool SMEM>
__device__ __forceinline__ void scan_counts(WideShared<SMEM>& sh, int L) {
  using BlockScan = typename WideShared<SMEM>::BlockScan;
  const int base = threadIdx.x * kScanItems;
  int v[kScanItems];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    v[j] = base + j < L ? static_cast<int>(sh.cnt[base + j]) : 0;
    sum += v[j];
  }
  int pre;
  BlockScan(sh.scan).ExclusiveSum(sum, pre);
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    if (base + j < L) sh.cnt[base + j] = pre;
    pre += v[j];
  }
  __syncthreads();
}

// One stable counting pass of the sort: the node indexes in[0, S) into
// out[0, S), ordered by digit(node) in [0, D), ties in input order. Warp
// w owns one contiguous chunk of the input; it counts its chunk's digits
// 32 nodes at a time (__match_any_sync groups a digit's lanes, the
// group's lowest lane adds the group's size), a block scan of the
// [digit][warp] table gives each (digit, warp) its first output slot, and
// a second walk places every node at that slot plus its rank among the
// lower lanes of its group. O(S) work and O(D * warps) for the table.
template <bool SMEM, typename Digit>
__device__ __forceinline__ void radix_pass(const int32_t* in, int32_t* out,
                                           int S, int D, Digit digit,
                                           WideShared<SMEM>& sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = min(kWideWarps, (S + 31) >> 5);
  const int per = (((S + nw - 1) / nw) + 31) & ~31;
  const int L = D * nw;
  for (int e = threadIdx.x; e < L; e += kWideBlock) sh.cnt[e] = 0;
  __syncthreads();
  const int lo = warp * per;
  const int hi = min(lo + per, S);
  const unsigned below = (1u << lane) - 1u;
  if (warp < nw) {
    for (int b = lo; b < hi; b += 32) {
      const int s = b + lane;
      const bool live = s < hi;
      const int d = live ? digit(in[s]) : D + lane;   // a unique dummy
      const unsigned peers = __match_any_sync(kFull, d);
      if (live && (peers & below) == 0) {
        sh.cnt[d * nw + warp] += __popc(peers);
      }
      __syncwarp();
    }
  }
  __syncthreads();
  scan_counts(sh, L);
  if (warp < nw) {
    for (int b = lo; b < hi; b += 32) {
      const int s = b + lane;
      const bool live = s < hi;
      const int v = live ? in[s] : 0;
      const int d = live ? digit(v) : D + lane;
      const unsigned peers = __match_any_sync(kFull, d);
      int at = 0;
      if (live) at = sh.cnt[d * nw + warp];
      __syncwarp();
      if (live) {
        out[at + __popc(peers & below)] = v;
        if ((peers & below) == 0) sh.cnt[d * nw + warp] = at + __popc(peers);
      }
      __syncwarp();
    }
  }
  __syncthreads();
}

// The RGA order of one job row per block, from the raw planes, the child
// sort included (the design note at the top of this file). SMEM: the row
// is staged into dynamic shared memory and every later gather is a
// shared-memory load; else the row is read in place and the work planes
// are a global scratch of 4 * wide_words(m) words a row (L2-resident).
// anchor != nullptr is the delta mode: the anchor key, tree_pos only.
template <bool SMEM>
__global__ void __launch_bounds__(kWideBlock, 1)
rga_wide_kernel(const int32_t* __restrict__ parent,
                const int32_t* __restrict__ elem,
                const int32_t* __restrict__ actor,
                const int32_t* __restrict__ anchor,
                const uint8_t* __restrict__ visible,
                const uint8_t* __restrict__ valid,
                int32_t* __restrict__ tree_pos,
                int32_t* __restrict__ vis_index,
                int32_t* __restrict__ node_at_pos,
                int32_t* __restrict__ length, int32_t* scratch, int m,
                int rounds) {
  __shared__ WideShared<SMEM> sh;
  extern __shared__ __align__(16) unsigned char wide_smem[];
  using BlockScan = typename WideShared<SMEM>::BlockScan;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int n = m;
  const bool delta = anchor != nullptr;
  const size_t off = static_cast<size_t>(blockIdx.x) * m;
  const size_t W = wide_words(m);

  // the row's planes: read-only sources, the sort's two index planes and
  // two work planes (in shared memory the staged elem and actor planes,
  // dead once the sort has read them)
  const int32_t* par;
  const int32_t* el;
  const int32_t* ac;
  const int32_t* an;
  const uint8_t* vl;
  const uint8_t* vb;
  int32_t *PX, *PY, *P2, *P3;
  int32_t *SA = nullptr, *SE = nullptr, *SC = nullptr, *SK = nullptr;
  uint8_t *SL = nullptr, *SV = nullptr;
  if (SMEM) {
    int32_t* w = reinterpret_cast<int32_t*>(wide_smem);
    SA = w;
    SE = w + W;
    SC = w + 2 * W;
    PX = w + 3 * W;
    PY = w + 4 * W;
    SK = delta ? w + 5 * W : nullptr;
    SL = reinterpret_cast<uint8_t*>(w + (delta ? 6 : 5) * W);
    SV = delta ? nullptr : SL + round16(static_cast<size_t>(n));
    par = SA;
    el = SE;
    ac = SC;
    an = SK;
    vl = SL;
    vb = SV;
    P2 = SE;
    P3 = SC;
  } else {
    int32_t* w = scratch + static_cast<size_t>(blockIdx.x) * 4 * W;
    PX = w;
    PY = w + W;
    P2 = w + 2 * W;
    P3 = w + 3 * W;
    par = parent + off;
    el = elem + off;
    ac = actor + off;
    an = delta ? anchor + off : nullptr;
    vl = valid + off;
    vb = delta ? nullptr : visible + off;
  }
  if (tid == 0) {
    sh.last = -1;
    sh.shown = 0;
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      sh.lo[f] = INT32_MAX;
      sh.hi[f] = INT32_MIN;
    }
  }
  __syncthreads();

  // ---- the valid extent: E = 1 + the last valid node (staged) ----
  {
    const uint8_t* g = valid + off;
    int last = -1;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
      const int q16 = n >> 4;
      for (int q = tid; q < q16; q += kWideBlock) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(g) + q);
        if (SMEM) reinterpret_cast<uint4*>(SL)[q] = x;
        const uint32_t wd[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int j = 3; j >= 0; --j) {
          if (wd[j]) {
            last = max(last, 16 * q + 4 * j + ((31 - __clz(wd[j])) >> 3));
            break;
          }
        }
      }
      done = 16 * q16;
    }
    for (int i = done + tid; i < n; i += kWideBlock) {
      const uint8_t b = g[i];
      if (SMEM) SL[i] = b;
      if (b) last = max(last, i);
    }
    last = __reduce_max_sync(kFull, last);
    if (lane == 0) atomicMax(&sh.last, last);
  }
  __syncthreads();
  const int E = max(sh.last + 1, 1);

  // ---- stage [0, E): parent, elem, actor (anchor); visible apart ----
  if (SMEM) {
    stage_async(SA, parent + off, E, n);
    stage_async(SE, elem + off, E, n);
    stage_async(SC, actor + off, E, n);
    if (delta) stage_async(SK, anchor + off, E, n);
    cp_async_commit();
    if (!delta) stage_async_bytes(SV, visible + off, E, n);
    cp_async_commit();
  }
  for (int s = tid; s < E; s += kWideBlock) PX[s] = s;   // while in flight
  if (SMEM) cp_async_wait<1>();
  __syncthreads();

  // ---- the extent vote: work on [0, E) only when every valid node's
  // parent is the head or an earlier valid node (an acyclic tree of the
  // valid nodes under the head), else on the whole width ----
  int bad = 0;
  for (int i = 1 + tid; i < E; i += kWideBlock) {
    if (vl[i]) {
      const int p = par[i];
      if (p != 0 && !(p > 0 && p < i && vl[p])) bad = 1;
    }
  }
  const bool ext = !__syncthreads_or(bad);
  const int S = ext ? E : n;
  if (S > E) {
    if (SMEM) {
      for (int i = E + tid; i < n; i += kWideBlock) {
        SA[i] = parent[off + i];
        SE[i] = elem[off + i];
        SC[i] = actor[off + i];
        if (delta) {
          SK[i] = anchor[off + i];
        } else {
          SV[i] = visible[off + i];
        }
      }
    }
    for (int s = E + tid; s < n; s += kWideBlock) PX[s] = s;
    __syncthreads();
  }
  if (!delta) {         // the padding's fixed outputs
    for (int i = S + tid; i < n; i += kWideBlock) {
      vis_index[off + i] = -1;
      node_at_pos[off + i] = n - 1;
    }
  }

  // the sort key's fields: parent_adj (the head and the invalid nodes
  // bucketed at S, after every valid node), anchor_k, elem, actor
  auto padj = [&](int v) { return (vl[v] && v != 0) ? par[v] : S; };
  auto akey = [&](int v) { return (delta && padj(v) == 0) ? an[v] : 0; };

  // ---- the fields' spans over [0, S) ----
  {
    int lo[4] = {INT32_MAX, INT32_MAX, INT32_MAX, INT32_MAX};
    int hi[4] = {INT32_MIN, INT32_MIN, INT32_MIN, INT32_MIN};
    for (int v = tid; v < S; v += kWideBlock) {
      const int x[4] = {padj(v), akey(v), el[v], ac[v]};
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        lo[f] = min(lo[f], x[f]);
        hi[f] = max(hi[f], x[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      lo[f] = __reduce_min_sync(kFull, lo[f]);
      hi[f] = __reduce_max_sync(kFull, hi[f]);
      if (lane == 0) {
        atomicMin(&sh.lo[f], lo[f]);
        atomicMax(&sh.hi[f], hi[f]);
      }
    }
  }
  __syncthreads();

  // ---- 0. the child sort: a stable LSD radix sort of the node indexes
  // by (parent_adj asc, anchor_k asc, elem desc, actor desc), one field at
  // a time from the least significant, kRadixBits bits a pass over each
  // field's span (x - min ascending, max - x descending); a stable sort of
  // index-ordered input breaks the last ties by index ----
  int32_t* src = PX;
  int32_t* dst = PY;
  for (int f = 3; f >= 0; --f) {
    const uint32_t lo = static_cast<uint32_t>(sh.lo[f]);
    const uint32_t hi = static_cast<uint32_t>(sh.hi[f]);
    const uint32_t span = hi - lo;
    const int bits = span ? 32 - __clz(span) : 0;
    auto field = [&](int v) -> uint32_t {
      switch (f) {
        case 0: return static_cast<uint32_t>(padj(v)) - lo;
        case 1: return static_cast<uint32_t>(akey(v)) - lo;
        case 2: return hi - static_cast<uint32_t>(el[v]);
        default: return hi - static_cast<uint32_t>(ac[v]);
      }
    };
    for (int shift = 0; shift < bits; shift += kRadixBits) {
      const int w = min(kRadixBits, bits - shift);
      const uint32_t mask = (1u << w) - 1u;
      radix_pass(src, dst, S, 1 << w,
                 [&](int v) { return static_cast<int>((field(v) >> shift) &
                                                      mask); },
                 sh);
      int32_t* t = src;
      src = dst;
      dst = t;
    }
  }
  const int32_t* ord = src;

  // ---- 1. thread the tree: P2 = first_child, P3 = next_sibling ----
  if (SMEM) cp_async_wait<0>();          // visible, staged during the sort
  int32_t* fc = P2;
  int32_t* ns = P3;
  for (int i = tid; i < S; i += kWideBlock) fc[i] = -1;
  __syncthreads();
  for (int s = tid; s < S; s += kWideBlock) {
    const int o = ord[s];
    const int p = padj(o);
    const bool start = s == 0 || padj(ord[s - 1]) != p;
    if (start && p >= 0 && p < S) fc[p] = o;
    int nx = -1;
    if (o != 0 && s + 1 < S) {   // head and padding share a sort bucket
      const int o2 = ord[s + 1];
      if (padj(o2) == p) nx = o2;
    }
    ns[o] = nx;
  }
  __syncthreads();

  // ---- 2. climb to the nearest ancestor-or-self with a sibling, until
  // no pointer moves (a fixed point stays one) or `rounds` rounds ----
  int32_t* ca = dst;                      // the free index plane
  int32_t* cb = src;                      // the order, read no more
  for (int i = tid; i < S; i += kWideBlock) {
    // under the extent vote an invalid node is nobody's ancestor: it
    // stays put (its successor is -1 whatever it climbs to)
    ca[i] = (ns[i] >= 0 || i == 0 || (ext && !vl[i]))
                ? i : min(max(par[i], 0), n - 1);
  }
  __syncthreads();
  for (int r = 0; r < rounds; ++r) {
    int moved = 0;
    for (int i = tid; i < S; i += kWideBlock) {
      const int c = ca[i];
      const int c2 = ca[c];
      cb[i] = c2;
      moved |= c2 != c;
    }
    moved = __syncthreads_or(moved);
    int32_t* t = ca;
    ca = cb;
    cb = t;
    if (!moved) break;
  }
  // successor chain into the free climb plane: nxt = succ, or S the
  // terminator (the plain version's n)
  int32_t* xa = cb;
  for (int i = tid; i < S; i += kWideBlock) {
    const int f = fc[i];
    int succ = f >= 0 ? f : ns[ca[i]];
    if (!vl[i]) succ = -1;
    xa[i] = succ >= 0 ? succ : S;
  }
  if (tid == 0) xa[S] = S;
  __syncthreads();

  // ---- 3. list-rank the chain, until nothing changes or `rounds`
  // rounds: dist in P2/P3, nxt in the climb pair ----
  int32_t* da = fc;
  int32_t* db = ns;
  int32_t* xb = ca;
  for (int i = tid; i <= S; i += kWideBlock) da[i] = i < S ? 1 : 0;
  if (tid == 0) {
    db[S] = 0;
    xb[S] = S;
  }
  __syncthreads();
  for (int r = 0; r < rounds; ++r) {
    int moved = 0;
    for (int i = tid; i < S; i += kWideBlock) {
      const int j = xa[i];
      const int dj = da[j];
      const int xj = xa[j];
      db[i] = static_cast<int>(static_cast<uint32_t>(da[i]) +
                               static_cast<uint32_t>(dj));
      xb[i] = xj;
      moved |= (dj != 0) | (xj != j);
    }
    moved = __syncthreads_or(moved);
    int32_t* t = da;
    da = db;
    db = t;
    t = xa;
    xa = xb;
    xb = t;
    if (!moved) break;
  }
  const uint32_t d0 = static_cast<uint32_t>(da[0]);
  int32_t* tp = db;                       // free: the last round's source
  for (int i = tid; i < S; i += kWideBlock) {
    const int t = static_cast<int>(d0 - static_cast<uint32_t>(da[i]));
    tp[i] = t;
    tree_pos[off + i] = t;
  }
  for (int i = S + tid; i < n; i += kWideBlock) {   // invalid: dist 1
    tree_pos[off + i] = static_cast<int>(d0 - 1u);
  }
  if (delta) return;                      // tree_pos is the delta output

  // ---- 4. node_at_pos, visibility scan, vis_index, length ----
  int32_t* nap = xb;                      // free
  for (int p = tid; p <= S; p += kWideBlock) nap[p] = p == 0 ? 0 : n - 1;
  __syncthreads();
  for (int i = tid; i < S; i += kWideBlock) {
    const int t = tp[i];
    if (vl[i] && t > 0 && t <= S) nap[t] = i;   // slot S is the sink
  }
  __syncthreads();
  // position 0 holds the head: its tree_pos is 0, so it is off the chain
  int32_t* vo = da;                       // every thread has read d0
  for (int p = tid; p < S; p += kWideBlock) {
    const int j = nap[p];
    node_at_pos[off + p] = j;
    // the fill n - 1 names a padding node (invalid) when S < n
    vo[p] = j < S ? (vl[j] && tp[j] > 0 && vb[j]) : 0;
  }
  __syncthreads();
  int carry = 0;
  for (int b = 0; b < S; b += kWideBlock) {
    const int p = b + tid;
    const int x = p < S ? vo[p] : 0;
    int y, total;
    BlockScan(sh.scan).ExclusiveSum(x, y, total);
    if (p < S) vo[p] = y + carry;
    carry += total;
    __syncthreads();
  }
  int mine = 0;
  for (int i = tid; i < S; i += kWideBlock) {
    const int t = tp[i];
    const bool shown = vb[i] && vl[i] && t > 0;
    vis_index[off + i] = shown ? vo[min(max(t, 0), n - 1)] : -1;
    mine += shown;
  }
  mine = __reduce_add_sync(kFull, mine);
  if (lane == 0) atomicAdd(&sh.shown, mine);
  __syncthreads();
  if (tid == 0) length[blockIdx.x] = sh.shown;
}

template <bool SMEM>
int launch_wide(const int32_t* parent, const int32_t* elem,
                const int32_t* actor, const int32_t* anchor,
                const uint8_t* visible, const uint8_t* valid,
                int32_t* tree_pos, int32_t* vis_index, int32_t* node_at_pos,
                int32_t* length, int32_t* scratch, int K, int m, int rounds,
                cudaStream_t stream) {
  const size_t dyn = SMEM ? wide_smem_bytes(m, anchor != nullptr) : 0;
  const cudaError_t e = opt_in_smem(rga_wide_kernel<SMEM>, dyn);
  if (e != cudaSuccess) return static_cast<int>(e);
  rga_wide_kernel<SMEM><<<K, kWideBlock, dyn, stream>>>(
      parent, elem, actor, anchor, visible, valid, tree_pos, vis_index,
      node_at_pos, length, scratch, m, rounds);
  return static_cast<int>(cudaGetLastError());
}


// ---- grid variant: one row over every SM --------------------------------

// Steps 1-4 over all K rows at once, each a grid-wide phase of ONE
// cooperative launch (csrc/grid.cuh), on five planes of K*(m+1) words
// in a global scratch: FC and NS (first child, next sibling; later the
// distance pair), two climb planes (later the successor pair) and NAP
// (node_at_pos). A thread owns the slots of its CTA's span and keeps
// each one's climb pointer, successor and distance in registers across
// the barriers (C block steps; C = 0 reloads them from the planes), so a
// doubling round costs one barrier and one dependent load per slot.
//
//   phase 0: FC = -1, NAP = n - 1, length = 0
//   phase 1: threading over sorted slots; the thread of sorted slot s
//            also writes the climb start of node order[s] (its next
//            sibling is its own to decide)
//   climb:   `rounds` rounds c = c[c]; the last one also resolves the
//            successor (slot n the terminator) into the free climb plane
//   rank:    `rounds` rounds dist += dist[nxt], nxt = nxt[nxt] (round
//            0's dist is 1 below n and 0 at n, never stored); the last
//            one also writes tree_pos (every thread reads its row's head
//            distance from the previous round) and scatters NAP
//   scan:    each CTA scans the visibility of its chunks of positions
//            (node_at_pos out), each chunk's total to chunk_sums
//   index:   each CTA scans the chunk totals into shared memory; a shown
//            node's vis_index is its chunk's row prefix + the local rank,
//            and the lengths are the shown nodes counted per row
//
// Position 0 always holds node 0: the head's tree_pos is 0, so it is off
// the chain and the plain version's "any node off the chain" holds on
// every row.
template <int C>
__global__ void __launch_bounds__(kGridBlock)
rga_grid_kernel(const int32_t* __restrict__ order,
                const int32_t* __restrict__ parent_adj,
                const int32_t* __restrict__ parent,
                const uint8_t* __restrict__ visible,
                const uint8_t* __restrict__ valid,
                int32_t* __restrict__ tree_pos,
                int32_t* __restrict__ vis_index,
                int32_t* __restrict__ node_at_pos, int32_t* length,
                int32_t* planes, int32_t* chunk_sums, int K, int m,
                int rounds, GridShape gs) {
  using BlockScan = cub::BlockScan<int, kGridBlock>;
  __shared__ typename BlockScan::TempStorage scan_tmp;
  __shared__ int win[kGridRowWin];
  extern __shared__ int32_t cs[];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();

  const int n = m;
  const int W = n + 1;
  const int total = K * W;
  const int tid = threadIdx.x;
  const int lo = blockIdx.x * gs.span;
  const int hi = min(lo + gs.span, total);
  const int steps = (hi - lo + kGridBlock - 1) / kGridBlock;
  int32_t* const D[2] = {planes, planes + total};          // FC, NS first
  int32_t* const CL[2] = {planes + 2 * total, planes + 3 * total};
  int32_t* const NAP = planes + 4 * total;
  constexpr int CR = C > 0 ? C : 1;
  int rx[CR], rd[CR];         // own slots' climb/successor and distance
  auto each = [&](auto&& body) { grid_each<C>(lo, steps, body); };

  // ---- phase 0 ----
  each([&](int, int g) {
    if (g < hi && g % W < n) {
      D[0][g] = -1;
      NAP[g] = n - 1;
    }
  });
  for (int k = blockIdx.x * kGridBlock + tid; k < K;
       k += gridDim.x * kGridBlock) {
    length[k] = 0;
  }
  grid.sync();

  // ---- phase 1: threading (slot g of row k = sorted position i) ----
  each([&](int, int g) {
    if (g >= hi) return;
    const int k = g / W;
    const int i = g - k * W;
    if (i >= n) return;
    const size_t off = static_cast<size_t>(k) * n;
    const int32_t* ord = order + off;
    const int32_t* padj = parent_adj + off;
    const int o = ord[i];
    const int p = padj[o];
    const int base = k * W;
    if ((i == 0 || padj[ord[i - 1]] != p) && p >= 0 && p < n) {
      D[0][base + p] = o;
    }
    int nx = -1;
    if (i + 1 < n && o != 0) {  // head and padding share a sort bucket
      const int o2 = ord[i + 1];
      if (padj[o2] == p) nx = o2;
    }
    D[1][base + o] = nx;
    CL[0][base + o] = (nx >= 0 || o == 0)
                          ? o : min(max(parent[off + o], 0), n - 1);
  });
  grid.sync();

  // ---- climb: c = c[c]; the last round resolves the successor ----
  for (int r = 0; r < rounds; ++r) {
    const int32_t* cur = CL[r & 1];
    int32_t* nxt = CL[(r + 1) & 1];
    const bool last = r + 1 == rounds;
    each([&](int j, int g) {
      if (g >= hi) return;
      const int k = g / W;
      const int i = g - k * W;
      if (i == n) {
        if (last) {
          nxt[g] = n;
          rx[j] = n;
        }
        return;
      }
      const int base = k * W;
      const int c = (C > 0 && r > 0) ? rx[j] : cur[g];
      const int c2 = cur[base + c];
      if (!last) {
        nxt[g] = c2;
        rx[j] = c2;
        return;
      }
      const int fc = D[0][g];
      int succ = fc >= 0 ? fc : D[1][base + c2];
      if (!valid[static_cast<size_t>(k) * n + i]) succ = -1;
      const int x = succ >= 0 ? succ : n;
      nxt[g] = x;
      rx[j] = x;
    });
    grid.sync();
  }

  // ---- rank: dist += dist[nxt], nxt = nxt[nxt]; last: tree_pos ----
  for (int r = 0; r < rounds; ++r) {
    const int32_t* xc = CL[(rounds + r) & 1];
    int32_t* xn = CL[(rounds + r + 1) & 1];
    const int32_t* dc = D[(r + 1) & 1];      // dist of round r (r >= 1)
    int32_t* dn = D[r & 1];
    const bool last = r + 1 == rounds;
    each([&](int j, int g) {
      if (g >= hi) return;
      const int k = g / W;
      const int i = g - k * W;
      const int base = k * W;
      const int x = C > 0 ? rx[j] : xc[g];
      const int d = r == 0 ? (i < n) : (C > 0 ? rd[j] : dc[g]);
      const int dx = r == 0 ? (x < n) : dc[base + x];
      if (!last) {
        const int xx = xc[base + x];
        dn[g] = d + dx;
        xn[g] = xx;
        rx[j] = xx;
        rd[j] = d + dx;
        return;
      }
      if (i == n) return;
      const int x0 = xc[base];
      const int d0 = r == 0 ? 1 + (x0 < n) : dc[base] + dc[base + x0];
      const int t = d0 - (d + dx);
      const size_t off = static_cast<size_t>(k) * n;
      tree_pos[off + i] = t;
      dn[g] = t;
      rd[j] = t;
      if (valid[off + i] && t > 0 && t <= n) NAP[base + t] = i;
    });
    grid.sync();
  }
  const int32_t* TP = D[(rounds + 1) & 1];   // written by the last round
  int32_t* VR = D[rounds & 1];

  // ---- scan: visibility over each chunk of positions ----
  for (int q = blockIdx.x; q < gs.chunks; q += gridDim.x) {
    const int k = q / gs.per;
    const int plo = (q - k * gs.per) * gs.clen;
    const int phi = min(plo + gs.clen, n);
    const int base = k * W;
    const size_t off = static_cast<size_t>(k) * n;
    int carry = 0;
    for (int b = plo; b < phi; b += kGridBlock) {
      const int p = b + tid;
      int x = 0;
      if (p < phi) {
        const int j = p == 0 ? 0 : NAP[base + p];
        node_at_pos[off + p] = j;
        x = valid[off + j] && TP[base + j] > 0 && visible[off + j];
      }
      int y, tot;
      BlockScan(scan_tmp).ExclusiveSum(x, y, tot);
      if (p < phi) VR[base + p] = carry + y;
      carry += tot;
      __syncthreads();
    }
    if (tid == 0) chunk_sums[q] = carry;
  }
  grid.sync();

  // ---- index: vis_index and the lengths ----
  scan_chunks<BlockScan>(chunk_sums, gs.chunks, cs, scan_tmp);
  row_win_clear<1>(win);
  __syncthreads();
  const int k_lo = lo / W;
  each([&](int j, int g) {
    int k = -1;
    int shown[1] = {0};
    const int kk = g / W;
    const int i = g - kk * W;
    if (g < hi && i < n) {
      k = kk;
      const size_t off = static_cast<size_t>(k) * n;
      const int t = C > 0 ? rd[j] : TP[g];
      shown[0] = visible[off + i] && valid[off + i] && t > 0;
      int v = -1;
      if (shown[0]) {
        const int tc = min(max(t, 0), n - 1);
        const int row = k * gs.per;
        v = VR[k * W + tc] + cs[row + tc / gs.clen] - cs[row];
      }
      vis_index[off + i] = v;
    }
    warp_row_add<1>(win, k_lo, length, k, shown);
  });
  __syncthreads();
  row_win_flush<1>(win, k_lo, K, length);
}

template <int C>
int launch_grid_c(const int32_t* order, const int32_t* parent_adj,
                  const int32_t* parent, const uint8_t* visible,
                  const uint8_t* valid, int32_t* tree_pos,
                  int32_t* vis_index, int32_t* node_at_pos, int32_t* length,
                  int32_t* scratch, int K, int m, int rounds,
                  const GridShape& gs, size_t smem, cudaStream_t stream) {
  const size_t total = static_cast<size_t>(K) * plane_words(m);
  return static_cast<int>(grid_launch(
      rga_grid_kernel<C>, gs, smem, stream, order, parent_adj, parent,
      visible, valid, tree_pos, vis_index, node_at_pos, length, scratch,
      scratch + 5 * total, K, m, rounds, gs));
}

// The grid variant's launch: the grid from the card's residency, then
// the kernel that keeps gs.regs slots a thread in registers (up to 4;
// past that it reloads them).
int launch_grid(const int32_t* order, const int32_t* parent_adj,
                const int32_t* parent, const uint8_t* visible,
                const uint8_t* valid, int32_t* tree_pos, int32_t* vis_index,
                int32_t* node_at_pos, int32_t* length, int32_t* scratch,
                int K, int m, int rounds, cudaStream_t stream) {
  const size_t smem = (grid_chunk_words(K) + 1) * sizeof(int32_t);
  GridShape gs;
  const cudaError_t e = grid_shape(
      smem, static_cast<long long>(K) * plane_words(m), K, m, &gs,
      rga_grid_kernel<0>, rga_grid_kernel<1>, rga_grid_kernel<2>,
      rga_grid_kernel<4>);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto go = [&](auto launcher) {
    return launcher(order, parent_adj, parent, visible, valid, tree_pos,
                    vis_index, node_at_pos, length, scratch, K, m, rounds,
                    gs, smem, stream);
  };
  if (gs.regs <= 1) return go(launch_grid_c<1>);
  if (gs.regs <= 2) return go(launch_grid_c<2>);
  if (gs.regs <= 4) return go(launch_grid_c<4>);
  return go(launch_grid_c<0>);
}

// An empty kernel of the grid variants' shape: `syncs` grid barriers and
// nothing else (the floor under each round of a cooperative launch), or
// with syncs = 0 an empty launch (the floor of one launch per round).
__global__ void __launch_bounds__(kGridBlock) grid_barrier_kernel(int syncs) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int s = 0; s < syncs; ++s) grid.sync();
}

}  // namespace

// Whether the wide variant keeps a row of width m in shared memory
// (delta != 0: the delta mode's planes); when it does not, the caller
// passes a global scratch of rga_wide_scratch_words(m) int32 a row.
extern "C" int rga_wide_uses_smem(int m, int delta) {
  return wide_smem_bytes(m, delta != 0) <= kWideDynLimit;
}

// Words of the wide variant's global scratch a row.
extern "C" long long rga_wide_scratch_words(int m) {
  return 4LL * static_cast<long long>(wide_words(m));
}

// C entry point of the wide variant (bound with ctypes): one block a row
// from the raw planes parent/elem/actor int32 [K, m] and visible/valid
// uint8 (bool) [K, m], the child sort inside; outputs tree_pos,
// vis_index, node_at_pos int32 [K, m] and length int32 [K]. With anchor
// (int32 [K, m]) the delta mode: visible, vis_index, node_at_pos and
// length may be null and only tree_pos is written. global != 0 runs on a
// scratch of K * rga_wide_scratch_words(m) int32, else in shared memory
// (rga_wide_uses_smem). Returns the CUDA error of the launch (0 on
// success).
extern "C" int rga_wide_launch(int global, const void* parent,
                               const void* elem, const void* actor,
                               const void* anchor, const void* visible,
                               const void* valid, void* tree_pos,
                               void* vis_index, void* node_at_pos,
                               void* length, void* scratch, int K, int m,
                               int rounds, void* stream) {
  if (K <= 0) return 0;
  const bool delta = anchor != nullptr;
  if (m < 1 || rounds < 1 || (global && scratch == nullptr) ||
      (!global && !rga_wide_uses_smem(m, delta)) ||
      (!delta && (visible == nullptr || vis_index == nullptr ||
                  node_at_pos == nullptr || length == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto go = [&](auto launcher) {
    return launcher(static_cast<const int32_t*>(parent),
                    static_cast<const int32_t*>(elem),
                    static_cast<const int32_t*>(actor),
                    static_cast<const int32_t*>(anchor),
                    static_cast<const uint8_t*>(visible),
                    static_cast<const uint8_t*>(valid),
                    static_cast<int32_t*>(tree_pos),
                    static_cast<int32_t*>(vis_index),
                    static_cast<int32_t*>(node_at_pos),
                    static_cast<int32_t*>(length),
                    static_cast<int32_t*>(scratch), K, m, rounds,
                    static_cast<cudaStream_t>(stream));
  };
  return global ? go(launch_wide<false>) : go(launch_wide<true>);
}

// Words of the grid variant's scratch at (K, m): five planes of K*(m+1)
// and the chunk table.
extern "C" long long rga_grid_scratch_words(int K, int m) {
  return 5LL * K * static_cast<long long>(plane_words(m)) +
         grid_chunk_words(K);
}

// C entry point of the grid variant (bound with ctypes), after a PyTorch
// child sort: order/parent_adj/parent int32 [K, m], visible/valid uint8
// (bool) [K, m], the outputs of rga_wide_launch, and a scratch of
// rga_grid_scratch_words(K, m) int32. One cooperative launch over every resident CTA; returns the
// CUDA error of the launch (0 on success; a card or stream that refuses
// a cooperative launch returns its error, never another variant).
extern "C" int rga_grid_launch(const void* order, const void* parent_adj,
                               const void* parent, const void* visible,
                               const void* valid, void* tree_pos,
                               void* vis_index, void* node_at_pos,
                               void* length, void* scratch, int K, int m,
                               int rounds, void* stream) {
  if (K <= 0) return 0;
  if (m < 1 || rounds < 1 || scratch == nullptr || K > kGridMaxRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_grid(static_cast<const int32_t*>(order),
                     static_cast<const int32_t*>(parent_adj),
                     static_cast<const int32_t*>(parent),
                     static_cast<const uint8_t*>(visible),
                     static_cast<const uint8_t*>(valid),
                     static_cast<int32_t*>(tree_pos),
                     static_cast<int32_t*>(vis_index),
                     static_cast<int32_t*>(node_at_pos),
                     static_cast<int32_t*>(length),
                     static_cast<int32_t*>(scratch), K, m, rounds,
                     static_cast<cudaStream_t>(stream));
}

// The grid variants' limits (csrc/grid.cuh): the most rows and the most
// slots one launch takes, which device/cuda_grid.py mirrors.
extern "C" long long grid_max_rows() { return kGridMaxRows; }
extern "C" long long grid_max_slots() { return kGridMaxSlots; }

// The floor under the grid variants' rounds (tools/torch_kernel_ab.py):
// one launch of an empty kernel on `ctas` CTAs of kGridBlock threads (0
// or more than the card holds resident: all resident), cooperative with
// `syncs` grid barriers when coop != 0, else a plain launch with none.
// Returns the launch's CUDA error.
extern "C" int grid_barrier_probe(int syncs, int coop, int ctas,
                                  void* stream) {
  GridShape gs;
  const cudaError_t e =
      grid_shape(0, static_cast<long long>(kGridMaxCtas) * kGridBlock, 1, 1,
                 &gs, grid_barrier_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (ctas > 0 && ctas < gs.ctas) gs.ctas = ctas;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (coop) {
    return static_cast<int>(grid_launch(grid_barrier_kernel, gs, 0, st,
                                        syncs));
  }
  grid_barrier_kernel<<<gs.ctas, kGridBlock, 0, st>>>(0);
  return static_cast<int>(cudaGetLastError());
}

// C entry point of the narrow variant (bound with ctypes): the raw planes
// parent/elem/actor int32 [K, m] and visible/valid uint8 (bool) [K, m],
// m <= 512; the outputs of rga_wide_launch. Returns the CUDA error
// of the launch (0 on success).
extern "C" int rga_narrow_launch(const void* parent, const void* elem,
                                 const void* actor, const void* visible,
                                 const void* valid, void* tree_pos,
                                 void* vis_index, void* node_at_pos,
                                 void* length, int K, int m, int rounds,
                                 void* stream) {
  return narrow_dispatch(parent, elem, actor, nullptr, visible, valid,
                         tree_pos, vis_index, node_at_pos, length, K, m,
                         rounds, stream);
}

// C entry point of the delta mode (bound with ctypes): the delta planes
// parent/anchor/elem/actor int32 [K, m] and valid uint8 (bool) [K, m];
// the output tree_pos int32 [K, m] (the caller reads its valid rows).
// variant (cuda_sequence._DELTA_VARIANTS): 0 the narrow kernel (one warp
// a row, m <= 512), 1 the subwarp kernel (32 / W rows a warp, m <= 32).
// Returns the CUDA error of the launch (0 on success).
extern "C" int rga_delta_run(int variant, const void* parent,
                             const void* anchor, const void* elem,
                             const void* actor, const void* valid,
                             void* tree_pos, int K, int m, int rounds,
                             void* stream) {
  if (K <= 0) return 0;
  if (anchor == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (variant == 1) {
    return subwarp_dispatch(static_cast<const int32_t*>(parent),
                            static_cast<const int32_t*>(anchor),
                            static_cast<const int32_t*>(elem),
                            static_cast<const int32_t*>(actor),
                            static_cast<const uint8_t*>(valid),
                            static_cast<int32_t*>(tree_pos), K, m, rounds,
                            static_cast<cudaStream_t>(stream));
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  return narrow_dispatch(parent, elem, actor, anchor, valid, valid,
                         tree_pos, nullptr, nullptr, nullptr, K, m, rounds,
                         stream);
}
