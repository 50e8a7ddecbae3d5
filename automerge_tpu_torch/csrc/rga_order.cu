// RGA ordering from the child-sorted permutation: tree threading, the
// ancestor climb, list ranking and the visibility scan of every dirty
// sequence object, one thread block per job row.
//
// Replaces the TPU kernel in automerge_tpu/device/pallas_sequence.py:63-208
// (_make_kernel, _rga_pallas_padded, rga_order_batch_pallas). That kernel
// sends every gather and scatter through one-hot MXU matmuls over [m, m]
// tiles (O(m^2) per round) because the TPU has no fast gather; on Hopper
// a gather is a plain indexed load, so this kernel does what the plain
// version (sequence._order_from_sorted_plain) does, directly, with the
// same round count and the same sentinel slots:
//
//   per job row (n = m nodes; node 0 is the head):
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
//        node_at_pos[p]; an exclusive block scan in chunks with a carried
//        offset (CUB); vis_index[i] = rank at tree_pos[i] for visible
//        on-chain nodes, else -1; length = their count
//
// Every doubling round reads one plane and writes the other (ping-pong
// buffers, one __syncthreads() per round): doubling in place with
// strided threads would race. The four working planes of n+1 words live
// in dynamic shared memory while they fit (m <= 12,799); past that the
// same kernel runs on a global-memory scratch tensor the caller
// allocates, so any m works.
//
// Bound on the H100: per call it must read K*m*(4+4+4+1+1) bytes and
// write K*m*12 + K*4 bytes; the pointer doubling does O(K*m*log m)
// dependent loads, served from shared memory below the cap. At the
// shapes of the main path (m = 64) it is bound by memory traffic and
// launch latency.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kSmemLimit = 200 * 1024;

__host__ __device__ inline size_t plane_words(int m) {
  return static_cast<size_t>(m) + 1;
}

template <int BLOCK>
__global__ void __launch_bounds__(BLOCK)
rga_order_kernel(const int32_t* __restrict__ order,
                 const int32_t* __restrict__ parent_adj,
                 const int32_t* __restrict__ parent,
                 const uint8_t* __restrict__ visible,
                 const uint8_t* __restrict__ valid,
                 int32_t* __restrict__ tree_pos,
                 int32_t* __restrict__ vis_index,
                 int32_t* __restrict__ node_at_pos,
                 int32_t* __restrict__ length, int32_t* scratch, int m,
                 int rounds, int use_smem) {
  using BlockScan = cub::BlockScan<int, BLOCK>;
  using BlockReduce = cub::BlockReduce<int, BLOCK>;
  __shared__ union {
    typename BlockScan::TempStorage scan;
    typename BlockReduce::TempStorage reduce;
  } tmp;
  extern __shared__ int32_t smem[];

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int n = m;
  const size_t W = plane_words(m);
  int32_t* base = use_smem ? smem : scratch + static_cast<size_t>(k) * 4 * W;
  int32_t* P[4] = {base, base + W, base + 2 * W, base + 3 * W};

  const size_t off = static_cast<size_t>(k) * m;
  const int32_t* ord = order + off;
  const int32_t* padj = parent_adj + off;
  const int32_t* par = parent + off;
  const uint8_t* vis = visible + off;
  const uint8_t* val = valid + off;

  // ---- 1. thread the tree: P0 = first_child, P1 = next_sibling ----
  int32_t* fc = P[0];
  int32_t* ns = P[1];
  for (int i = tid; i < n; i += BLOCK) fc[i] = -1;
  __syncthreads();
  for (int s = tid; s < n; s += BLOCK) {
    const int o = ord[s];
    const int p = padj[o];
    const bool start = s == 0 || padj[ord[s - 1]] != p;
    if (start && p >= 0 && p < n) fc[p] = o;
    int nx = -1;
    if (s + 1 < n) {
      const int o2 = ord[s + 1];
      if (padj[o2] == p) nx = o2;
    }
    ns[o] = nx;
  }
  __syncthreads();
  if (tid == 0) ns[0] = -1;   // head and padding share a sort bucket
  __syncthreads();

  // ---- 2. climb to the nearest ancestor-or-self with a sibling ----
  int32_t* c_cur = P[2];
  int32_t* c_nxt = P[3];
  for (int i = tid; i < n; i += BLOCK) {
    c_cur[i] = (ns[i] >= 0 || i == 0) ? i : min(max(par[i], 0), n - 1);
  }
  __syncthreads();
  for (int r = 0; r < rounds; ++r) {
    for (int i = tid; i < n; i += BLOCK) c_nxt[i] = c_cur[c_cur[i]];
    __syncthreads();
    int32_t* t = c_cur;
    c_cur = c_nxt;
    c_nxt = t;
  }
  // successor chain into the free climb plane: nxt = succ or n
  int32_t* nx_cur = c_nxt;
  for (int i = tid; i < n; i += BLOCK) {
    int succ = fc[i] >= 0 ? fc[i] : ns[c_cur[i]];
    if (!val[i]) succ = -1;
    nx_cur[i] = succ >= 0 ? succ : n;
  }
  if (tid == 0) nx_cur[n] = n;
  __syncthreads();

  // ---- 3. list-rank the chain: dist in P0/P1, nxt in the climb pair ----
  int32_t* nx_nxt = c_cur;
  int32_t* d_cur = P[0];
  int32_t* d_nxt = P[1];
  for (int i = tid; i <= n; i += BLOCK) d_cur[i] = i < n ? 1 : 0;
  __syncthreads();
  for (int r = 0; r < rounds; ++r) {
    for (int i = tid; i <= n; i += BLOCK) {
      const int j = nx_cur[i];
      d_nxt[i] = d_cur[i] + d_cur[j];
      nx_nxt[i] = nx_cur[j];
    }
    __syncthreads();
    int32_t* t = d_cur;
    d_cur = d_nxt;
    d_nxt = t;
    t = nx_cur;
    nx_cur = nx_nxt;
    nx_nxt = t;
  }
  // tree positions into d_nxt; node_at_pos into nx_nxt (both free now)
  int32_t* tp = d_nxt;
  int32_t* nap = nx_nxt;
  const int d0 = d_cur[0];
  for (int i = tid; i < n; i += BLOCK) {
    const int t = d0 - d_cur[i];
    tp[i] = t;
    tree_pos[off + i] = t;
  }
  for (int p = tid; p <= n; p += BLOCK) nap[p] = n - 1;
  __syncthreads();

  // ---- 4. visibility scan ----
  int off_chain = 0;
  for (int i = tid; i < n; i += BLOCK) {
    const int t = tp[i];
    if (val[i] && t > 0) {
      if (t <= n) nap[t] = i;
    } else {
      off_chain = 1;
    }
  }
  off_chain = __syncthreads_or(off_chain);
  if (off_chain && tid == 0) nap[0] = 0;
  __syncthreads();
  // vis_ordered into d_cur (the final distances are no longer needed:
  // every thread read d0 before the barrier above)
  int32_t* vo = d_cur;
  for (int p = tid; p < n; p += BLOCK) {
    const int j = nap[p];
    node_at_pos[off + p] = j;
    vo[p] = (val[j] && tp[j] > 0 && vis[j]) ? 1 : 0;
  }
  __syncthreads();
  int carry = 0;
  for (int b = 0; b < n; b += BLOCK) {
    const int p = b + tid;
    const int x = p < n ? vo[p] : 0;
    int y, total;
    BlockScan(tmp.scan).ExclusiveSum(x, y, total);
    if (p < n) vo[p] = y + carry;
    carry += total;
    __syncthreads();        // temp storage reuse + vo visibility
  }
  int mine = 0;
  for (int i = tid; i < n; i += BLOCK) {
    const int t = tp[i];
    const bool shown = vis[i] && val[i] && t > 0;
    vis_index[off + i] = shown ? vo[min(max(t, 0), n - 1)] : -1;
    mine += shown;
  }
  const int total = BlockReduce(tmp.reduce).Sum(mine);
  if (tid == 0) length[k] = total;
}

template <int BLOCK>
int launch(const int32_t* order, const int32_t* parent_adj,
           const int32_t* parent, const uint8_t* visible,
           const uint8_t* valid, int32_t* tree_pos, int32_t* vis_index,
           int32_t* node_at_pos, int32_t* length, int32_t* scratch, int K,
           int m, int rounds, cudaStream_t stream) {
  const size_t bytes = 4 * plane_words(m) * 4;
  const int use_smem = bytes <= static_cast<size_t>(kSmemLimit);
  const size_t smem = use_smem ? bytes : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rga_order_kernel<BLOCK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  rga_order_kernel<BLOCK><<<K, BLOCK, smem, stream>>>(
      order, parent_adj, parent, visible, valid, tree_pos, vis_index,
      node_at_pos, length, scratch, m, rounds, use_smem);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Whether a launch at width m keeps its planes in shared memory; when it
// does not, the caller passes a global scratch of K*4*(m+1) int32.
extern "C" int rga_order_uses_smem(int m) {
  return 4 * plane_words(m) * 4 <= static_cast<size_t>(kSmemLimit);
}

// C entry point (bound with ctypes). order/parent_adj/parent are int32
// [K, m], visible/valid uint8 (bool) [K, m]; outputs tree_pos, vis_index,
// node_at_pos int32 [K, m] and length int32 [K]. Returns the CUDA error
// of the launch (0 on success).
extern "C" int rga_order_launch(const void* order, const void* parent_adj,
                                const void* parent, const void* visible,
                                const void* valid, void* tree_pos,
                                void* vis_index, void* node_at_pos,
                                void* length, void* scratch, int K, int m,
                                int rounds, void* stream) {
  if (K <= 0) return 0;
  auto args = [&](auto launcher) {
    return launcher(static_cast<const int32_t*>(order),
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
  };
  if (m <= 64) return args(launch<64>);
  if (m <= 128) return args(launch<128>);
  if (m <= 256) return args(launch<256>);
  if (m <= 4096) return args(launch<512>);
  return args(launch<1024>);
}
