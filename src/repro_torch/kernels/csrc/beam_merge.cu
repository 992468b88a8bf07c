// Deduplicating top-L beam merge, for Hopper.
//
// Replaces the Pallas TPU kernel beam_merge_pallas
// (repro/kernels/beam_merge.py:254, body _beam_merge_kernel :195-250).
//
// Per row b: a finite candidate whose id already appeared on an earlier finite
// candidate is suppressed to +inf (keep-first dedup; keep[b, j] marks the
// survivors). Then the best L of the concatenation [beam (L) | candidates (C)]
// are emitted in the order (mono_key(d), concat index): ascending distance,
// exact ties resolved by position, beam first. mono_key is the order-
// isomorphic uint32 of the float with -0.0 taken as +0.0 (beam_merge.py:66).
// The output is bitwise that of the stable-sort oracle, ties included.
//
// What bounds it on the H100: neither bytes (about 2-3 KB per row in and out)
// nor arithmetic throughput in the usual sense, but the compare work of the
// dedup and the selection, all of it in shared memory.
//
// Design: one block of 256 threads per row; the row lives in shared memory.
// Neither step sorts. The finite candidates are first collected into a list
// (a shared-memory counter hands out slots, in any order), and a finite
// candidate is a duplicate when that list holds the same id at an earlier
// position -- O(F_c^2) for F_c finite candidates, not O(C^2). The same is
// done for the finite elements of the concatenation (F of them). Selection
// then gives every element its rank in the (key, index) total order:
//   * a finite element counts the finite elements before it: O(F) each;
//   * every finite element precedes every +inf one, so an +inf element at
//     index e has rank F + (e - finite elements before e) >= e; only the
//     ones at e < L can reach the output, and they need the same O(F) count.
// An element whose rank is below L writes itself to that output slot. With
// distinct indices the ranks are a permutation, so the first L slots are
// written exactly once, in the stable order by construction -- without
// relying on the beam being sorted. In the search most candidates are +inf
// (label-invalid or visited), so F stays near the beam width; the Pallas
// kernel's bitonic network does O(P log^2 P) compare-exchanges at a fixed
// P = next_pow2(L + next_pow2(C)), with a barrier per stage.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kInfBits = 0x7f800000u;

__device__ __forceinline__ uint32_t mono_key(float d) {
  if (d == 0.f) d = 0.f;  // -0.0 -> +0.0
  const uint32_t bits = __float_as_uint(d);
  return (bits >> 31) ? ~bits : (bits | 0x80000000u);
}

__device__ __forceinline__ bool is_pos_inf(float d) {
  return __float_as_uint(d) == kInfBits;
}

__global__ void __launch_bounds__(kThreads) beam_merge_kernel(
    const float* __restrict__ beam_d, const int* __restrict__ beam_ids,
    const uint8_t* __restrict__ beam_exp, const float* __restrict__ cand_d,
    const int* __restrict__ cand_ids, int L, int C, int n,
    int* __restrict__ out_ids, float* __restrict__ out_d,
    uint8_t* __restrict__ out_exp, uint8_t* __restrict__ keep) {
  extern __shared__ uint32_t smem[];
  const int P = L + C;
  float* s_d = reinterpret_cast<float*>(smem);              // [P]
  int* s_id = reinterpret_cast<int*>(s_d + P);              // [P]
  uint32_t* f_key = reinterpret_cast<uint32_t*>(s_id + P);  // [P] finite keys
  int* f_idx = reinterpret_cast<int*>(f_key + P);           // [P] their indices
  int* fc_id = f_idx + P;                                   // [C] finite cand ids
  int* fc_j = fc_id + C;                                    // [C] their positions
  uint8_t* s_exp = reinterpret_cast<uint8_t*>(fc_j + C);    // [P]
  __shared__ int n_fc, n_f, first_inf_c;

  const int b = blockIdx.x;
  const size_t bl = static_cast<size_t>(b) * L;
  const size_t bc = static_cast<size_t>(b) * C;
  if (threadIdx.x == 0) {
    n_fc = 0;
    n_f = 0;
    first_inf_c = C;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < L; i += kThreads) {
    s_d[i] = beam_d[bl + i];
    s_id[i] = beam_ids[bl + i];
    s_exp[i] = beam_exp[bl + i];
  }
  for (int j = threadIdx.x; j < C; j += kThreads) {
    const float d = cand_d[bc + j];
    const int id = cand_ids[bc + j];
    s_d[L + j] = d;
    s_id[L + j] = id;
    if (isfinite(d)) {
      const int slot = atomicAdd(&n_fc, 1);
      fc_id[slot] = id;
      fc_j[slot] = j;
    } else {
      atomicMin(&first_inf_c, j);
    }
  }
  __syncthreads();

  // keep-first dedup: a finite candidate is dropped when an earlier finite
  // candidate has its id (or, as in the reference, when its id is the
  // sentinel n and an earlier candidate is not finite)
  for (int j = threadIdx.x; j < C; j += kThreads) {
    float d = s_d[L + j];
    if (isfinite(d)) {
      const int id = s_id[L + j];
      bool dup = id == n && first_inf_c < j;
      for (int s = 0; s < n_fc && !dup; ++s) dup = fc_id[s] == id && fc_j[s] < j;
      if (dup) d = __uint_as_float(kInfBits);
    }
    const bool kept = isfinite(d);
    s_d[L + j] = d;
    s_exp[L + j] = kept ? 0 : 1;
    keep[bc + j] = kept ? 1 : 0;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < P; e += kThreads) {
    if (!is_pos_inf(s_d[e])) {
      const int slot = atomicAdd(&n_f, 1);
      f_key[slot] = mono_key(s_d[e]);
      f_idx[slot] = e;
    }
  }
  __syncthreads();

  // stable selection: rank of e in the (key, index) order
  const int nf = n_f;
  for (int e = threadIdx.x; e < P; e += kThreads) {
    int rank = 0;
    if (is_pos_inf(s_d[e])) {
      if (e >= L) continue;  // rank >= e >= L
      int before = 0;
      for (int s = 0; s < nf; ++s) before += f_idx[s] < e;
      rank = nf + e - before;
    } else {
      const uint32_t k = mono_key(s_d[e]);
      for (int s = 0; s < nf && rank < L; ++s) {
        const uint32_t kf = f_key[s];
        rank += (kf < k) || (kf == k && f_idx[s] < e);
      }
    }
    if (rank < L) {
      out_ids[bl + rank] = s_id[e];
      out_d[bl + rank] = s_d[e];
      out_exp[bl + rank] = s_exp[e];
    }
  }
}

}  // namespace

extern "C" int beam_merge(const float* beam_d, const int* beam_ids,
                          const uint8_t* beam_exp, const float* cand_d,
                          const int* cand_ids, int B, int L, int C, int n,
                          int* out_ids, float* out_d, uint8_t* out_exp,
                          uint8_t* keep, void* stream) {
  if (B == 0) return 0;
  const size_t P = static_cast<size_t>(L) + C;
  const size_t smem = P * (4 * sizeof(uint32_t) + 1) + 2 * C * sizeof(int);
  if (smem > 46 * 1024) {  // past the default 48 KB with the static counters
    cudaError_t err = cudaFuncSetAttribute(
        beam_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  beam_merge_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      beam_d, beam_ids, beam_exp, cand_d, cand_ids, L, C, n, out_ids, out_d,
      out_exp, keep);
  return static_cast<int>(cudaGetLastError());
}
