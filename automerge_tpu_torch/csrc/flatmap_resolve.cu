// Flat-map field resolution: per document, which assignment ops survive
// and which one wins each field, in two variants.
//
// Replaces the TPU kernel in automerge_tpu/device/pallas_merge.py:42-193
// (_make_kernel, _resolve_pallas_padded, resolve_assignments_batch_pallas).
// That kernel compares every op with every other op of its document in
// 128 x 128 tiles (O(N^2) per document) and gathers clock entries through
// one-hot MXU matmuls, because the TPU has neither fast gathers nor fast
// scattered atomics. On Hopper both are cheap, so this kernel computes the
// plain version (merge._resolve_core over one document's segment slots)
// with shared-memory atomic maxima, O(N * A) per document:
//
//   tgt_i = seg_i if 0 <= seg_i < S, else the sink S (never read back);
//   g_i   = the gather slot (a negative id wraps once, then clamps into
//           [0, S)); g_i == tgt_i for every in-range op
//   1. cmax[tgt_i][a] max= valid_i ? clock[i][a] : -1 for every actor a
//   2. seen_i = cmax[g_i][clamp(actor_i, 0, A-1)]; op i survives iff
//      valid && !(seen_i >= seq_i) && !is_del
//   3. per slot, the highest actor among the survivors (-1 for an op that
//      did not survive) and the lowest op index at that actor
//
// Max is order-free, so the result is deterministic and bit-equal to the
// plain version whatever order the atomics land in.
//
// Bound on the H100: per call it must read D*N*(4+4+4+1+1) + D*N*A*4 bytes
// and write D*N + 2*D*S*4 bytes, with O(D*N*A) integer maxima: bound by
// memory traffic (the clock plane is most of it) and, per document, by
// the latency of a few dependent steps.
//
// Warp variant (fm_warp_kernel; cuda_merge.variant says which shapes
// take it): one warp per document, 8 documents per CTA (fewer where the
// slices are large), only __syncwarp.
//   - Each lane loads 4 consecutive ops a round: seg_id, actor and seq as
//     16-byte vectors, is_del and valid as one 32-bit word each (scalar
//     loads where N % 4 != 0 or a row is misaligned), and stashes them in
//     the warp's shared slice; global memory is not read again.
//   - The warp reads the document's N*A clock words as one contiguous,
//     coalesced stream (16-byte vectors where A % 4 == 0), 8 vectors a
//     lane in flight; each vector belongs to one op, whose slot comes
//     from the stash. A word's (op, actor) is tracked incrementally: no
//     division in the loop.
//   - Only slots [0, S) exist: an out-of-range op scatters nothing (the
//     sink is never read) and reads its surviving bit from slot g.
//   - The winner election is one 64-bit atomicMax per op on
//     (score << 32) | low, score = the actor of a survivor and -1
//     otherwise, low = N - i for a survivor and 0 otherwise. The high
//     word of a slot is its seg_max_actor (INT32_MIN when untouched, -1
//     when it holds only dead ops), and low gives the winner (-1 when 0):
//     among equal scores the largest low is the lowest index.
//   - surviving goes out as one 32-bit word of 4 bytes a lane, winner
//     and seg_max_actor one slot a lane, coalesced.
//
// Block variant (fm_block_kernel, the rest): one 128- or 256-thread block
// per document, the slots (S+1 of them, slot S the sink) in dynamic
// shared memory while (S+1)*(A+2) words fit in 200 KB, else in a global
// scratch the caller allocates ('block-global'); four passes split by
// __syncthreads, as first built.
//
// Split variant (fm_split_kernel; cuda_merge.variant takes it for a few
// long documents, cuda_merge.SPLIT_BANDS): a batch of one or a few long
// documents (replica sync's union of one hot document: D = 1, N =
// 65,536, S = 4,096, A = 16) leaves the variants above on one CTA a
// document, so on a few of the 132 SMs, and past the shared-memory cap
// every clock word becomes a global atomic from that one SM. This
// variant cuts the flat D*N op space into spans of kGridBlock-op tiles,
// one span a CTA, over as many CTAs as there are tiles (up to all
// resident), and keeps the slots in a global scratch in the L2: winner
// keys [D*S] (int64) and clock maxima [D*S, A]. Four phases:
//   fill:  keys = LLONG_MIN, cmax = INT_MIN (the caller's scratch is
//          uninitialised)
//   clock: each tile's op codes (global slot d*S + g, in range, valid)
//          into a shared stash, then its clock words as one coalesced
//          stream (16-byte vectors where A % 4 == 0, no division a
//          word), each scattered with atomicMax into its op's slot: the
//          warp variant's stream with a CTA-wide stride
//   keys:  survivorship per op from cmax, surviving written coalesced,
//          one 64-bit atomicMax of the warp variant's winner key per
//          in-range op
// Where the slots of the documents a CTA's span touches fit 48 KB
// (documents with few fields), the clock and key phases combine in a
// CTA-local table in shared memory first, then add each touched word to
// the global table with one atomic: a document of 65,536 ops over 32
// fields would otherwise send 2,048 atomics to each of its L2 words.
// Replica sync's 4,096 fields (64K clock words) take the global table
// directly; a warp's 8 ops of a 16-actor stream rarely share a slot
// there.
//   emit:  winner and seg_max_actor from the keys, one slot a thread
// separated by grid barriers in one cooperative launch (csrc/grid.cuh).

#include <algorithm>
#include <climits>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "grid.cuh"
#include "smem.cuh"

namespace {

constexpr int kSmemLimit = 200 * 1024;
constexpr int kWarpDocs = 8;           // documents (warps) per CTA
constexpr int kBatch = 8;              // clock vectors a lane has in flight

// variants of the C entry point (cuda_merge._VARIANTS)
constexpr int kVariantWarp = 0, kVariantBlock = 1, kVariantBlockGlobal = 2,
              kVariantSplit = 3;

// stash code word of an op: gather slot, in range, valid, deleted
constexpr int kSlotMask = (1 << 28) - 1;
constexpr int kInRange = 1 << 28;
constexpr int kValid = 1 << 29;
constexpr int kDel = 1 << 30;

__host__ __device__ inline size_t round16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// bytes of one warp's shared slice: S winner keys (int64), S*A clock
// maxima, then the stash (code, actor, seq) of round4(N) ops each
__host__ __device__ inline size_t warp_slice_bytes(int N, int S, int A) {
  return round16(static_cast<size_t>(S) * 8) +
         round16(static_cast<size_t>(S) * A * 4) +
         static_cast<size_t>(12) * round4(N);
}

__host__ __device__ inline size_t block_slot_bytes(int S, int A) {
  return static_cast<size_t>(S + 1) * (A + 2) * 4;
}

__device__ __forceinline__ long long winner_key(int score, unsigned low) {
  return static_cast<long long>(
      (static_cast<unsigned long long>(static_cast<unsigned>(score)) << 32) |
      low);
}

template <typename V>
__device__ __forceinline__ void scatter_words(int32_t* slot, const V& c,
                                              bool ok) {
  if constexpr (std::is_same<V, int4>::value) {
    atomicMax(slot, ok ? c.x : -1);
    atomicMax(slot + 1, ok ? c.y : -1);
    atomicMax(slot + 2, ok ? c.z : -1);
    atomicMax(slot + 3, ok ? c.w : -1);
  } else {
    atomicMax(slot, ok ? c : -1);
  }
}

// pass 1b: a run of n_ops ops' clock words as one coalesced stream of
// V-sized vectors (int4 needs A % 4 == 0, so a vector never straddles
// two ops), STRIDE threads reading neighbouring vectors, each vector
// scattered into the slot of its op (its stash code's slot, an index
// into cmax's rows of A words)
template <typename V, int STRIDE>
__device__ __forceinline__ void clock_stream(const int32_t* __restrict__ clk,
                                             int n_ops, int A,
                                             const int* st_code,
                                             int32_t* cmax, int t) {
  constexpr int VW = sizeof(V) / 4;
  const V* src = reinterpret_cast<const V*>(clk);
  const int n_vec = n_ops * A / VW;
  // (op, actor) of the thread's first word, and its step per round
  int j = VW * t / A, a = VW * t - j * A;
  const int q = STRIDE * VW / A, r = STRIDE * VW - q * A;
  for (int v0 = t; v0 < n_vec; v0 += STRIDE * kBatch) {
    V c[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (v0 + STRIDE * b < n_vec) c[b] = __ldcs(src + v0 + STRIDE * b);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (v0 + STRIDE * b < n_vec) {
        const int code = st_code[j];
        if (code & kInRange) {
          scatter_words(
              cmax + static_cast<size_t>(code & kSlotMask) * A + a, c[b],
              code & kValid);
        }
      }
      a += r;
      j += q;
      if (a >= A) {
        a -= A;
        ++j;
      }
    }
  }
}

// ---- warp variant: one warp per document ---------------------------------

__global__ void __launch_bounds__(32 * kWarpDocs)
fm_warp_kernel(const int32_t* __restrict__ seg_id,
               const int32_t* __restrict__ actor,
               const int32_t* __restrict__ seq,
               const int32_t* __restrict__ clock,
               const uint8_t* __restrict__ is_del,
               const uint8_t* __restrict__ valid,
               uint8_t* __restrict__ surviving, int32_t* __restrict__ winner,
               int32_t* __restrict__ seg_max_actor, int D, int N, int S,
               int A, int vec_ops, int vec_clock) {
  extern __shared__ __align__(16) unsigned char fm_smem[];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int rows = blockDim.x >> 5;
  const int n4 = round4(N);
  unsigned char* base = fm_smem + wid * warp_slice_bytes(N, S, A);
  long long* keys = reinterpret_cast<long long*>(base);
  int32_t* cmax =
      reinterpret_cast<int32_t*>(base + round16(static_cast<size_t>(S) * 8));
  int* st_code = reinterpret_cast<int*>(
      base + round16(static_cast<size_t>(S) * 8) +
      round16(static_cast<size_t>(S) * A * 4));
  int* st_act = st_code + n4;
  int* st_seq = st_act + n4;

  const int d = blockIdx.x * rows + wid;
  if (d >= D) return;
  const size_t row = static_cast<size_t>(d) * N;
  // the slots' fill, 16 bytes a store (each region is padded to 16)
  const int n_key4 =
      static_cast<int>(round16(static_cast<size_t>(S) * 8) / 16);
  const int n_cmax4 =
      static_cast<int>(round16(static_cast<size_t>(S) * A * 4) / 16);
  const longlong2 key_fill = make_longlong2(LLONG_MIN, LLONG_MIN);
  const int4 cmax_fill = make_int4(INT_MIN, INT_MIN, INT_MIN, INT_MIN);
  for (int w = lane; w < n_key4; w += 32) {
    reinterpret_cast<longlong2*>(keys)[w] = key_fill;
  }
  for (int w = lane; w < n_cmax4; w += 32) {
    reinterpret_cast<int4*>(cmax)[w] = cmax_fill;
  }

  // pass 1a: each lane's 4 consecutive ops a round into the stash
  for (int i0 = 4 * lane; i0 < N; i0 += 128) {
    int4 sg, ac, sq;
    unsigned dl, vl;
    if (vec_ops) {
      sg = __ldg(reinterpret_cast<const int4*>(seg_id + row + i0));
      ac = __ldg(reinterpret_cast<const int4*>(actor + row + i0));
      sq = __ldg(reinterpret_cast<const int4*>(seq + row + i0));
      dl = __ldg(reinterpret_cast<const unsigned*>(is_del + row + i0));
      vl = __ldg(reinterpret_cast<const unsigned*>(valid + row + i0));
    } else {
      int s4[4] = {0, 0, 0, 0}, a4[4] = {0, 0, 0, 0}, q4[4] = {0, 0, 0, 0};
      dl = vl = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const size_t i = row + i0 + e;
        if (i0 + e < N) {
          s4[e] = __ldg(seg_id + i);
          a4[e] = __ldg(actor + i);
          q4[e] = __ldg(seq + i);
          dl |= static_cast<unsigned>(__ldg(is_del + i) != 0) << (8 * e);
          vl |= static_cast<unsigned>(__ldg(valid + i) != 0) << (8 * e);
        }
      }
      sg = make_int4(s4[0], s4[1], s4[2], s4[3]);
      ac = make_int4(a4[0], a4[1], a4[2], a4[3]);
      sq = make_int4(q4[0], q4[1], q4[2], q4[3]);
    }
    const int s4[4] = {sg.x, sg.y, sg.z, sg.w};
    int c4[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int s = s4[e];
      const int g = min(max(s < 0 ? s + S : s, 0), S - 1);
      c4[e] = g | ((s >= 0 && s < S) ? kInRange : 0) |
              (((vl >> (8 * e)) & 0xff) ? kValid : 0) |
              (((dl >> (8 * e)) & 0xff) ? kDel : 0);
    }
    *reinterpret_cast<int4*>(st_code + i0) =
        make_int4(c4[0], c4[1], c4[2], c4[3]);
    *reinterpret_cast<int4*>(st_act + i0) = ac;
    *reinterpret_cast<int4*>(st_seq + i0) = sq;
  }
  __syncwarp();

  // pass 1b: per-slot clock maxima
  if (vec_clock) {
    clock_stream<int4, 32>(clock + row * A, N, A, st_code, cmax, lane);
  } else {
    clock_stream<int, 32>(clock + row * A, N, A, st_code, cmax, lane);
  }
  __syncwarp();

  // pass 2: survivorship, then one winner-key maximum per in-range op
  for (int i0 = 4 * lane; i0 < N; i0 += 128) {
    const int4 cd = *reinterpret_cast<const int4*>(st_code + i0);
    const int4 ac = *reinterpret_cast<const int4*>(st_act + i0);
    const int4 sq = *reinterpret_cast<const int4*>(st_seq + i0);
    const int c4[4] = {cd.x, cd.y, cd.z, cd.w};
    const int a4[4] = {ac.x, ac.y, ac.z, ac.w};
    const int q4[4] = {sq.x, sq.y, sq.z, sq.w};
    unsigned sv = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (i0 + e < N) {
        const int code = c4[e];
        const int g = code & kSlotMask;
        const int seen = cmax[g * A + min(max(a4[e], 0), A - 1)];
        const bool surv = (code & kValid) && !(seen >= q4[e]) &&
                          !(code & kDel);
        sv |= static_cast<unsigned>(surv) << (8 * e);
        if (code & kInRange) {
          atomicMax(&keys[g],
                    surv ? winner_key(a4[e], static_cast<unsigned>(
                                                 N - (i0 + e)))
                         : winner_key(-1, 0u));
        }
      }
    }
    if (vec_ops) {
      *reinterpret_cast<unsigned*>(surviving + row + i0) = sv;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (i0 + e < N) surviving[row + i0 + e] = (sv >> (8 * e)) & 1;
      }
    }
  }
  __syncwarp();

  // outputs: one slot a lane, coalesced
  const size_t srow = static_cast<size_t>(d) * S;
  for (int s = lane; s < S; s += 32) {
    const long long k = keys[s];
    const unsigned low = static_cast<unsigned>(k & 0xffffffffll);
    seg_max_actor[srow + s] = static_cast<int>(k >> 32);
    winner[srow + s] = low == 0 ? -1 : N - static_cast<int>(low);
  }
}

// ---- block variant: one thread block per document ------------------------

template <int BLOCK>
__global__ void __launch_bounds__(BLOCK)
fm_block_kernel(const int32_t* __restrict__ seg_id,
                const int32_t* __restrict__ actor,
                const int32_t* __restrict__ seq,
                const int32_t* __restrict__ clock,
                const uint8_t* __restrict__ is_del,
                const uint8_t* __restrict__ valid,
                uint8_t* __restrict__ surviving,
                int32_t* __restrict__ winner,
                int32_t* __restrict__ seg_max_actor,
                int32_t* scratch, int N, int S, int A, int use_smem) {
  extern __shared__ int32_t smem[];
  const int d = blockIdx.x;
  const int tid = threadIdx.x;
  const int W = S + 1;
  const size_t slots = static_cast<size_t>(W) * (A + 2);
  int32_t* cmax = use_smem ? smem : scratch + d * slots;
  int32_t* amax = cmax + static_cast<size_t>(W) * A;
  int32_t* imax = amax + W;

  const size_t row = static_cast<size_t>(d) * N;
  const int32_t* seg_d = seg_id + row;
  const int32_t* act_d = actor + row;
  const int32_t* seq_d = seq + row;
  const int32_t* clk_d = clock + row * A;
  const uint8_t* del_d = is_del + row;
  const uint8_t* val_d = valid + row;
  uint8_t* surv_d = surviving + row;

  for (size_t j = tid; j < slots; j += BLOCK) cmax[j] = INT_MIN;
  __syncthreads();

  // 1. per-slot clock maxima (the clock rows read once, coalesced)
  const size_t n_clk = static_cast<size_t>(N) * A;
  for (size_t j = tid; j < n_clk; j += BLOCK) {
    const int i = static_cast<int>(j / A);
    const int a = static_cast<int>(j - static_cast<size_t>(i) * A);
    const int s = seg_d[i];
    const int tgt = (s >= 0 && s < S) ? s : S;
    atomicMax(&cmax[static_cast<size_t>(tgt) * A + a],
              val_d[i] ? clk_d[j] : -1);
  }
  __syncthreads();

  // 2. survivorship, then per-slot actor maxima of the survivors
  for (int i = tid; i < N; i += BLOCK) {
    const int s = seg_d[i];
    const int tgt = (s >= 0 && s < S) ? s : S;
    const int g = min(max(s < 0 ? s + S : s, 0), S - 1);
    const int ai = act_d[i];
    const int a = min(max(ai, 0), A - 1);
    const int seen = cmax[static_cast<size_t>(g) * A + a];
    const bool surv = val_d[i] && !(seen >= seq_d[i]) && !del_d[i];
    surv_d[i] = surv;
    atomicMax(&amax[tgt], surv ? ai : -1);
  }
  __syncthreads();

  // 3. lowest op index at the winning actor (as the max of -index); each
  // thread re-reads only the survivor flags it wrote itself
  for (int i = tid; i < N; i += BLOCK) {
    const int s = seg_d[i];
    const int tgt = (s >= 0 && s < S) ? s : S;
    const int g = min(max(s < 0 ? s + S : s, 0), S - 1);
    const bool at_w = surv_d[i] && act_d[i] == amax[g];
    atomicMax(&imax[tgt], at_w ? -i : -N - 1);
  }
  __syncthreads();

  // 4. per-segment outputs (the sink slot S is dropped)
  const size_t srow = static_cast<size_t>(d) * S;
  for (int s = tid; s < S; s += BLOCK) {
    const int w = imax[s];
    winner[srow + s] = w < -N ? -1 : -w;
    seg_max_actor[srow + s] = amax[s];
  }
}

// ---- split variant: each document's ops over many CTAs --------------------

// The four phases of a split launch.
constexpr int kPhaseFill = 0, kPhaseClock = 1, kPhaseKeys = 2,
              kPhaseEmit = 3;
// Bytes of a split CTA's local slot table (dynamic shared memory): the
// clock maxima, then the winner keys, of the documents its span touches,
// when they fit.
constexpr int kSplitLocalBytes = 48 * 1024;

// The four phases over the flat D*N op space, CTA b taking the ops
// [b * span, (b + 1) * span), in tiles of kGridBlock ops (one a
// thread), with a grid barrier between two phases (one cooperative
// launch). keys [D*S] and cmax [D*S, A] are the global
// tables the launch fills, so they are read with plain loads. LOCAL: a
// CTA first takes the maxima of its span's documents (local_docs of
// them from its first) in a shared table, then adds each word it
// touched to the global one with one atomic: a span that hits few
// slots (a document with few fields) contends in shared memory, not on
// a few L2 words. (A template flag, so that every atomic's address
// space is known when it compiles.)
template <bool VEC, bool LOCAL>
__global__ void __launch_bounds__(kGridBlock)
fm_split_kernel(const int32_t* __restrict__ seg_id,
                const int32_t* __restrict__ actor,
                const int32_t* __restrict__ seq,
                const int32_t* __restrict__ clock,
                const uint8_t* __restrict__ is_del,
                const uint8_t* __restrict__ valid,
                uint8_t* __restrict__ surviving, int32_t* __restrict__ winner,
                int32_t* __restrict__ seg_max_actor, long long* keys,
                int32_t* cmax, int D, int N, int S, int A, int span,
                int local_docs) {
  __shared__ int st_code[kGridBlock];
  extern __shared__ __align__(16) unsigned char split_smem[];
  const int tid = threadIdx.x;
  const int total = D * N;
  const int slots = D * S;
  const int lo = blockIdx.x * span;
  const int hi = min(lo + span, total);
  // the slots the CTA addresses: its span's documents' in a local table
  // from slot `base`, else every document's in the global one
  const int base = LOCAL ? lo / N * S : 0;
  const int local_slots = local_docs * S;
  const int gt = blockIdx.x * kGridBlock + tid;
  const int gstride = gridDim.x * kGridBlock;
  for (int phase = kPhaseFill; phase <= kPhaseEmit; ++phase) {
    if (phase == kPhaseFill) {
      for (int q = gt; q < slots; q += gstride) keys[q] = LLONG_MIN;
      const size_t words = static_cast<size_t>(slots) * A;
      for (size_t q = gt; q < words; q += gstride) cmax[q] = INT_MIN;
    } else if (phase == kPhaseClock) {
      int32_t* tbl = cmax;
      if (LOCAL) {
        tbl = reinterpret_cast<int32_t*>(split_smem);
        for (int q = tid; q < local_slots * A; q += kGridBlock) {
          tbl[q] = INT_MIN;
        }
      }
      // each tile: its ops' codes into the stash, then its clock words
      // as one coalesced stream into the slots' maxima
      for (int t0 = lo; t0 < hi; t0 += kGridBlock) {
        const int nt = min(kGridBlock, hi - t0);
        __syncthreads();          // the previous tile's stream is done
        if (tid < nt) {
          const int i = t0 + tid;
          const int d = i / N;
          const int s = __ldg(seg_id + i);
          const int g = min(max(s < 0 ? s + S : s, 0), S - 1);
          st_code[tid] = (d * S + g - base) |
                         ((s >= 0 && s < S) ? kInRange : 0) |
                         (__ldg(valid + i) ? kValid : 0);
        }
        __syncthreads();
        const int32_t* clk = clock + static_cast<size_t>(t0) * A;
        if (VEC) {
          clock_stream<int4, kGridBlock>(clk, nt, A, st_code, tbl, tid);
        } else {
          clock_stream<int, kGridBlock>(clk, nt, A, st_code, tbl, tid);
        }
      }
      if (LOCAL) {
        // every word the span touched, once into the global maxima
        __syncthreads();
        int32_t* dst = cmax + static_cast<size_t>(base) * A;
        for (int q = tid; q < local_slots * A; q += kGridBlock) {
          if (tbl[q] != INT_MIN) atomicMax(dst + q, tbl[q]);
        }
      }
    } else if (phase == kPhaseKeys) {
      long long* ktbl = keys;
      if (LOCAL) {
        ktbl = reinterpret_cast<long long*>(split_smem);
        for (int q = tid; q < local_slots; q += kGridBlock) {
          ktbl[q] = LLONG_MIN;
        }
        __syncthreads();
      }
      // survivorship, then one winner-key maximum per in-range op
      for (int i = lo + tid; i < hi; i += kGridBlock) {
        const int d = i / N;
        const int s = __ldg(seg_id + i);
        const int g = min(max(s < 0 ? s + S : s, 0), S - 1);
        const int ai = __ldg(actor + i);
        const int q = __ldg(seq + i);
        const size_t slot = static_cast<size_t>(d) * S + g;
        const int seen = cmax[slot * A + min(max(ai, 0), A - 1)];
        const bool surv = __ldg(valid + i) && !(seen >= q) &&
                          !__ldg(is_del + i);
        surviving[i] = surv;
        if (s >= 0 && s < S) {
          atomicMax(&ktbl[slot - base],
                    surv ? winner_key(ai, static_cast<unsigned>(
                                              N - (i - d * N)))
                         : winner_key(-1, 0u));
        }
      }
      if (LOCAL) {
        __syncthreads();
        for (int q = tid; q < local_slots; q += kGridBlock) {
          if (ktbl[q] != LLONG_MIN) atomicMax(&keys[base + q], ktbl[q]);
        }
      }
    } else {
      // outputs: one slot a thread, coalesced
      for (int q = gt; q < slots; q += gstride) {
        const long long k = keys[q];
        const unsigned low = static_cast<unsigned>(k & 0xffffffffll);
        seg_max_actor[q] = static_cast<int>(k >> 32);
        winner[q] = low == 0 ? -1 : N - static_cast<int>(low);
      }
    }
    if (phase < kPhaseEmit) cooperative_groups::this_grid().sync();
  }
}

struct Args {
  const int32_t* seg_id;
  const int32_t* actor;
  const int32_t* seq;
  const int32_t* clock;
  const uint8_t* is_del;
  const uint8_t* valid;
  uint8_t* surviving;
  int32_t* winner;
  int32_t* seg_max_actor;
  int D, N, S, A;
  cudaStream_t stream;
};

template <int ALIGN>
bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & (ALIGN - 1)) == 0;
}

int launch_warp(const Args& a) {
  const size_t wb = warp_slice_bytes(a.N, a.S, a.A);
  const int rows = static_cast<int>(std::min<size_t>(
      kWarpDocs, static_cast<size_t>(kSmemLimit) / wb));
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = wb * rows;
  const cudaError_t e = opt_in_smem(fm_warp_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int vec_ops = a.N % 4 == 0 && aligned<16>(a.seg_id) &&
                      aligned<16>(a.actor) && aligned<16>(a.seq) &&
                      aligned<4>(a.is_del) && aligned<4>(a.valid) &&
                      aligned<4>(a.surviving);
  const int vec_clock = a.A % 4 == 0 && aligned<16>(a.clock);
  const int grid = (a.D + rows - 1) / rows;
  fm_warp_kernel<<<grid, 32 * rows, smem, a.stream>>>(
      a.seg_id, a.actor, a.seq, a.clock, a.is_del, a.valid, a.surviving,
      a.winner, a.seg_max_actor, a.D, a.N, a.S, a.A, vec_ops, vec_clock);
  return static_cast<int>(cudaGetLastError());
}

template <int BLOCK>
int launch_block(const Args& a, int32_t* scratch, int use_smem) {
  const size_t smem = use_smem ? block_slot_bytes(a.S, a.A) : 0;
  const cudaError_t e = opt_in_smem(fm_block_kernel<BLOCK>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  fm_block_kernel<BLOCK><<<a.D, BLOCK, smem, a.stream>>>(
      a.seg_id, a.actor, a.seq, a.clock, a.is_del, a.valid, a.surviving,
      a.winner, a.seg_max_actor, scratch, a.N, a.S, a.A, use_smem);
  return static_cast<int>(cudaGetLastError());
}

// The split variant: one cooperative launch of its four phases. The
// scratch holds D*S winner keys (int64, first), then D*S*A clock maxima.
int launch_split(const Args& a, int32_t* scratch) {
  const long long total = static_cast<long long>(a.D) * a.N;
  if (scratch == nullptr || static_cast<long long>(a.D) * a.S > kSlotMask ||
      total > kGridMaxSlots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = a.A % 4 == 0 && aligned<16>(a.clock);
  GridShape gs;
  const cudaError_t e = grid_shape(
      kSplitLocalBytes, total, 1, 1, &gs, fm_split_kernel<true, true>,
      fm_split_kernel<true, false>, fm_split_kernel<false, true>,
      fm_split_kernel<false, false>);
  if (e != cudaSuccess) return static_cast<int>(e);
  long long* keys = reinterpret_cast<long long*>(scratch);
  int32_t* cmax = scratch + 2 * static_cast<size_t>(a.D) * a.S;
  // the documents a span of gs.span ops can touch, and whether their
  // slots fit the local table
  const long long docs =
      std::min<long long>(a.D, (gs.span - 1) / a.N + 2);
  const long long words = docs * a.S * std::max(a.A, 2);
  const int local_docs = words * 4 <= kSplitLocalBytes
                             ? static_cast<int>(docs) : 0;
  const size_t smem = local_docs ? static_cast<size_t>(words) * 4 : 0;
  auto* fn = vec ? (local_docs ? fm_split_kernel<true, true>
                               : fm_split_kernel<true, false>)
                 : (local_docs ? fm_split_kernel<false, true>
                               : fm_split_kernel<false, false>);
  return static_cast<int>(grid_launch(
      fn, gs, smem, a.stream, a.seg_id, a.actor, a.seq, a.clock, a.is_del,
      a.valid, a.surviving, a.winner, a.seg_max_actor, keys, cmax, a.D, a.N,
      a.S, a.A, gs.span, local_docs));
}

int run(int variant, const Args& a, int32_t* scratch) {
  if (a.D <= 0) return 0;
  if (variant == kVariantWarp) return launch_warp(a);
  if (variant == kVariantSplit) return launch_split(a, scratch);
  const int use_smem = variant == kVariantBlock;
  if ((!use_smem && variant != kVariantBlockGlobal) ||
      use_smem != (block_slot_bytes(a.S, a.A) <=
                   static_cast<size_t>(kSmemLimit)) ||
      (!use_smem && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<size_t>(a.N) * a.A <= 1024) {
    return launch_block<128>(a, scratch, use_smem);
  }
  return launch_block<256>(a, scratch, use_smem);
}

Args make_args(const void* seg_id, const void* actor, const void* seq,
               const void* clock, const void* is_del, const void* valid,
               void* surviving, void* winner, void* seg_max_actor, int D,
               int N, int S, int A, void* stream) {
  return Args{static_cast<const int32_t*>(seg_id),
              static_cast<const int32_t*>(actor),
              static_cast<const int32_t*>(seq),
              static_cast<const int32_t*>(clock),
              static_cast<const uint8_t*>(is_del),
              static_cast<const uint8_t*>(valid),
              static_cast<uint8_t*>(surviving),
              static_cast<int32_t*>(winner),
              static_cast<int32_t*>(seg_max_actor),
              D,
              N,
              S,
              A,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// C entry point (bound with ctypes). seg_id/actor/seq are int32 [D, N],
// clock int32 [D, N, A], is_del/valid uint8 (bool) [D, N]; outputs are
// surviving uint8 (bool) [D, N], winner and seg_max_actor int32 [D, S].
// variant, which cuda_merge.variant picks: 0 warp, 1 block, 2 block with
// its slots in a global scratch of D*(S+1)*(A+2) int32 that the caller
// allocates, and 3 split (one cooperative launch) on a scratch of
// D*S*(A+2) int32 (cuda_merge.split_scratch_words) that the caller
// allocates and the launch fills; a variant the shape cannot take is
// refused. Returns the CUDA error of the
// launch (0 on success).
extern "C" int flatmap_resolve_run(int variant, const void* seg_id,
                                   const void* actor, const void* seq,
                                   const void* clock, const void* is_del,
                                   const void* valid, void* surviving,
                                   void* winner, void* seg_max_actor,
                                   void* scratch, int D, int N, int S, int A,
                                   void* stream) {
  return run(variant,
             make_args(seg_id, actor, seq, clock, is_del, valid, surviving,
                       winner, seg_max_actor, D, N, S, A, stream),
             static_cast<int32_t*>(scratch));
}
