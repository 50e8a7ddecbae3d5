// Edit-stream kernel: winner/visibility diff -> pre-ordered, delta-sized
// edit buffers, one thread block per dirty sequence object.
//
// Replaces the TPU kernel in automerge_tpu/device/pallas_view.py:145-258
// (_make_edit_kernel, _edit_stream_pallas_core, edit_stream_pallas).
// That kernel sends every scatter and gather through one-hot MXU
// matmuls because the TPU has no fast gather; on Hopper a gather is a
// plain indexed load, so this kernel does what the plain version
// (cuda_view._edit_core) does, directly:
//
//   per job row k, per class c in (remove, insert, set):
//     mask/key/vals from the decoded planes
//       remove: pv & ~nv          key = prior idx   vals = (prior idx)
//       insert: nv & ~pv          key = new idx     vals = (node, new idx)
//       set:    nv & pv & touched key = new idx     vals = (node, new idx)
//     1. mark a presence grid at clamp(key, 0, m-1)
//     2. block-wide exclusive scan of the grid, in chunks of the block
//        size with a carried offset (CUB BlockScan)
//     3. each masked node writes its vals at rank = grid[key] when
//        rank < e_pad (larger ranks are dropped, as in the reference)
//     4. cnt[k, c] = number of masked nodes (not clamped to e_pad)
//
// The vis planes are decoded in the loads (the packed word
// prior_vis<<31 | visible<<30 | (prior_idx+1)<<15 | (new_idx+1), or the
// four cols planes), and touched is read straight from the np.packbits
// plane (MSB first) — the unpack that dispatch_edit_stream did in the
// TPU package is fused here. The grid lives in a [K, m] int32 scratch
// tensor the caller allocates, so no shared-memory limit caps m.
//
// Bound on the H100: per call it must read K*m*4 + K*ceil(m/8) bytes
// (packed) and write 5*K*e_pad*4 + 12*K bytes, with O(K*m) integer work:
// memory- and launch-bound, far below any arithmetic limit. This first
// version re-reads the planes once per class and pass (6 reads of each
// word, mostly from L1/L2) and keeps the grid in device memory; staging
// a row in shared memory is the obvious next step.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

namespace {

struct Node {
  bool pv, nv, touched;
  int pi, ni;
};

__device__ __forceinline__ Node decode(int fmt, const int32_t* vis,
                                       const uint8_t* pvp,
                                       const uint8_t* nvp,
                                       const int32_t* pip,
                                       const int32_t* nip,
                                       const uint8_t* trow, size_t off,
                                       int l) {
  Node nd;
  if (fmt == 0) {
    const uint32_t v = static_cast<uint32_t>(vis[off + l]);
    nd.pv = (v >> 31) & 1u;
    nd.nv = (v >> 30) & 1u;
    nd.pi = static_cast<int>((v >> 15) & 0x7FFFu) - 1;
    nd.ni = static_cast<int>(v & 0x7FFFu) - 1;
  } else {
    nd.pv = pvp[off + l] != 0;
    nd.nv = nvp[off + l] != 0;
    nd.pi = pip[off + l];
    nd.ni = nip[off + l];
  }
  nd.touched = (trow[l >> 3] >> (7 - (l & 7))) & 1;
  return nd;
}

// class c of node nd: whether it is masked, and its grid key
__device__ __forceinline__ bool in_class(int c, const Node& nd, int* key) {
  if (c == 0) {
    *key = nd.pi;
    return nd.pv && !nd.nv;
  }
  *key = nd.ni;
  if (c == 1) return nd.nv && !nd.pv;
  return nd.nv && nd.pv && nd.touched;
}

template <int BLOCK>
__global__ void __launch_bounds__(BLOCK)
edit_stream_kernel(int fmt, const int32_t* __restrict__ vis,
                   const uint8_t* __restrict__ pvp,
                   const uint8_t* __restrict__ nvp,
                   const int32_t* __restrict__ pip,
                   const int32_t* __restrict__ nip,
                   const uint8_t* __restrict__ touched,
                   int32_t* __restrict__ rm_idx,
                   int32_t* __restrict__ ins_node,
                   int32_t* __restrict__ ins_idx,
                   int32_t* __restrict__ set_node,
                   int32_t* __restrict__ set_idx,
                   int32_t* __restrict__ cnt, int32_t* grid_all, int m,
                   int mb, int e_pad) {
  using BlockScan = cub::BlockScan<int, BLOCK>;
  __shared__ typename BlockScan::TempStorage scan_tmp;
  __shared__ int s_count;

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t off = static_cast<size_t>(k) * m;
  const size_t eoff = static_cast<size_t>(k) * e_pad;
  const uint8_t* trow = touched + static_cast<size_t>(k) * mb;
  int32_t* grid = grid_all + off;

  for (int e = tid; e < e_pad; e += BLOCK) {
    rm_idx[eoff + e] = -1;
    ins_node[eoff + e] = -1;
    ins_idx[eoff + e] = -1;
    set_node[eoff + e] = -1;
    set_idx[eoff + e] = -1;
  }

  for (int c = 0; c < 3; ++c) {
    for (int l = tid; l < m; l += BLOCK) grid[l] = 0;
    if (tid == 0) s_count = 0;
    __syncthreads();

    // 1. presence grid + class count
    int mine = 0;
    for (int l = tid; l < m; l += BLOCK) {
      const Node nd = decode(fmt, vis, pvp, nvp, pip, nip, trow, off, l);
      int key;
      if (in_class(c, nd, &key)) {
        grid[min(max(key, 0), m - 1)] = 1;
        ++mine;
      }
    }
    if (mine) atomicAdd(&s_count, mine);
    __syncthreads();

    // 2. exclusive scan over m in chunks, carrying the running total
    int carry = 0;
    for (int base = 0; base < m; base += BLOCK) {
      const int l = base + tid;
      const int x = l < m ? grid[l] : 0;
      int y, total;
      BlockScan(scan_tmp).ExclusiveSum(x, y, total);
      if (l < m) grid[l] = y + carry;
      carry += total;
      __syncthreads();       // scan_tmp reuse + grid visibility
    }

    // 3. compaction: vals at rank, ranks >= e_pad dropped
    for (int l = tid; l < m; l += BLOCK) {
      const Node nd = decode(fmt, vis, pvp, nvp, pip, nip, trow, off, l);
      int key;
      if (!in_class(c, nd, &key)) continue;
      const int r = grid[min(max(key, 0), m - 1)];
      if (r >= e_pad) continue;
      if (c == 0) {
        rm_idx[eoff + r] = nd.pi;
      } else if (c == 1) {
        ins_node[eoff + r] = l;
        ins_idx[eoff + r] = nd.ni;
      } else {
        set_node[eoff + r] = l;
        set_idx[eoff + r] = nd.ni;
      }
    }
    // 4. the count, then a barrier before the next class clears the grid
    if (tid == 0) cnt[static_cast<size_t>(k) * 3 + c] = s_count;
    __syncthreads();
  }
}

template <int BLOCK>
void launch(int fmt, const int32_t* vis, const uint8_t* pvp,
            const uint8_t* nvp, const int32_t* pip, const int32_t* nip,
            const uint8_t* touched, int32_t* rm_idx, int32_t* ins_node,
            int32_t* ins_idx, int32_t* set_node, int32_t* set_idx,
            int32_t* cnt, int32_t* grid, int K, int m, int mb, int e_pad,
            cudaStream_t stream) {
  edit_stream_kernel<BLOCK><<<K, BLOCK, 0, stream>>>(
      fmt, vis, pvp, nvp, pip, nip, touched, rm_idx, ins_node, ins_idx,
      set_node, set_idx, cnt, grid, m, mb, e_pad);
}

}  // namespace

// C entry point (bound with ctypes). fmt 0: `vis` is the packed int32
// [K, m] word plane; fmt 1: pv/nv are uint8 (bool) and pi/ni int32
// [K, m] planes. touched is uint8 [K, mb] (mb = ceil(m / 8)). Outputs
// are int32 [K, e_pad] x 5 and [K, 3]; grid is int32 [K, m] scratch.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int edit_stream_launch(int fmt, const void* vis, const void* pv,
                                  const void* nv, const void* pi,
                                  const void* ni, const void* touched,
                                  void* rm_idx, void* ins_node,
                                  void* ins_idx, void* set_node,
                                  void* set_idx, void* cnt, void* grid,
                                  int K, int m, int mb, int e_pad,
                                  void* stream) {
  if (K <= 0) return 0;
  auto args = [&](auto launcher) {
    launcher(fmt, static_cast<const int32_t*>(vis),
             static_cast<const uint8_t*>(pv),
             static_cast<const uint8_t*>(nv),
             static_cast<const int32_t*>(pi),
             static_cast<const int32_t*>(ni),
             static_cast<const uint8_t*>(touched),
             static_cast<int32_t*>(rm_idx), static_cast<int32_t*>(ins_node),
             static_cast<int32_t*>(ins_idx),
             static_cast<int32_t*>(set_node),
             static_cast<int32_t*>(set_idx), static_cast<int32_t*>(cnt),
             static_cast<int32_t*>(grid), K, m, mb, e_pad,
             static_cast<cudaStream_t>(stream));
  };
  if (m <= 64) {
    args(launch<64>);
  } else if (m <= 128) {
    args(launch<128>);
  } else {
    args(launch<256>);
  }
  return static_cast<int>(cudaGetLastError());
}
