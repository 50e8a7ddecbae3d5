// Flat-map field resolution: per document, which assignment ops survive
// and which one wins each field, one thread block per document.
//
// Replaces the TPU kernel in automerge_tpu/device/pallas_merge.py:42-193
// (_make_kernel, _resolve_pallas_padded, resolve_assignments_batch_pallas).
// That kernel compares every op with every other op of its document in
// 128 x 128 tiles (O(N^2) per document) and gathers clock entries through
// one-hot MXU matmuls, because the TPU has neither fast gathers nor fast
// scattered atomics. On Hopper both are cheap, so this kernel computes the
// plain version (merge._resolve_core over one document's S + 1 segment
// slots; slot S is the sink that out-of-range segment ids scatter into)
// with shared-memory atomic maxima, O(N * A) per document:
//
//   slots: cmax[S+1][A] clock maxima, amax[S+1] actor maxima,
//          imax[S+1] maxima of the negated winner index; all INT32_MIN
//   1. every op i scatters max(cmax[tgt_i][a], valid_i ? clock[i][a] : -1)
//      for each actor column a (tgt_i = seg_i if 0 <= seg_i < S, else S)
//   2. seen_i = cmax[g_i][clamp(actor_i, 0, A-1)], g_i the gather slot
//      (a negative id wraps once, then clamps into [0, S)); op i survives
//      iff valid && !(seen_i >= seq_i) && !is_del; then
//      amax[tgt_i] max= survives ? actor_i : -1
//   3. imax[tgt_i] max= (survives && actor_i == amax[g_i]) ? -i : -N-1
//   4. winner[s] = imax[s] < -N ? -1 : -imax[s]; seg_max_actor[s] = amax[s]
//
// Max is order-free, so the result is deterministic and bit-equal to the
// plain version whatever order the atomics land in. The slots live in
// dynamic shared memory while (S+1)*(A+2) words fit; past that the same
// kernel runs on a global-memory scratch tensor the caller allocates.
//
// Bound on the H100: per call it must read D*N*(4+4+4+1+1) + D*N*A*4 bytes
// and write D*N + 2*D*S*4 bytes with O(D*N*A) integer max operations:
// memory-bound. One pass reads the clock rows (coalesced across the
// block); the per-op columns are read twice, the second time from L1/L2.

#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kSmemLimit = 200 * 1024;

template <int BLOCK>
__global__ void __launch_bounds__(BLOCK)
flatmap_resolve_kernel(const int32_t* __restrict__ seg_id,
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

template <int BLOCK>
int launch(const int32_t* seg_id, const int32_t* actor, const int32_t* seq,
           const int32_t* clock, const uint8_t* is_del, const uint8_t* valid,
           uint8_t* surviving, int32_t* winner, int32_t* seg_max_actor,
           int32_t* scratch, int D, int N, int S, int A,
           cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(S + 1) * (A + 2) * 4;
  const int use_smem = bytes <= static_cast<size_t>(kSmemLimit);
  const size_t smem = use_smem ? bytes : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flatmap_resolve_kernel<BLOCK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  flatmap_resolve_kernel<BLOCK><<<D, BLOCK, smem, stream>>>(
      seg_id, actor, seq, clock, is_del, valid, surviving, winner,
      seg_max_actor, scratch, N, S, A, use_smem);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Whether a launch at (S, A) keeps its slots in shared memory; when it
// does not, the caller passes a global scratch of D*(S+1)*(A+2) int32.
extern "C" int flatmap_resolve_uses_smem(int S, int A) {
  return static_cast<size_t>(S + 1) * (A + 2) * 4 <=
         static_cast<size_t>(kSmemLimit);
}

// C entry point (bound with ctypes). seg_id/actor/seq are int32 [D, N],
// clock int32 [D, N, A], is_del/valid uint8 (bool) [D, N]; outputs are
// surviving uint8 (bool) [D, N], winner and seg_max_actor int32 [D, S].
// Returns the CUDA error of the launch (0 on success).
extern "C" int flatmap_resolve_launch(const void* seg_id, const void* actor,
                                      const void* seq, const void* clock,
                                      const void* is_del, const void* valid,
                                      void* surviving, void* winner,
                                      void* seg_max_actor, void* scratch,
                                      int D, int N, int S, int A,
                                      void* stream) {
  if (D <= 0) return 0;
  auto args = [&](auto launcher) {
    return launcher(static_cast<const int32_t*>(seg_id),
                    static_cast<const int32_t*>(actor),
                    static_cast<const int32_t*>(seq),
                    static_cast<const int32_t*>(clock),
                    static_cast<const uint8_t*>(is_del),
                    static_cast<const uint8_t*>(valid),
                    static_cast<uint8_t*>(surviving),
                    static_cast<int32_t*>(winner),
                    static_cast<int32_t*>(seg_max_actor),
                    static_cast<int32_t*>(scratch), D, N, S, A,
                    static_cast<cudaStream_t>(stream));
  };
  if (static_cast<size_t>(N) * A <= 1024) return args(launch<128>);
  return args(launch<256>);
}
