// Deduplicating top-L beam merge, for Hopper; optionally sets the kept
// candidates' visited bits in the same pass.
//
// Replaces the Pallas TPU kernel beam_merge_pallas
// (repro/kernels/beam_merge.py:273, body _beam_merge_kernel :195-250) and the
// packed search branch's bitmap scatter after it (repro/search/batched.py:236-243).
//
// Per row b: a finite candidate whose id already appeared on an earlier
// candidate is suppressed to +inf (keep-first dedup; keep[b, j] marks the
// survivors; a non-finite candidate carries the id n, as in ref.dedup_mask).
// Then the best L of the concatenation [beam (L) | candidates (C)] are
// emitted in the order (mono_key(d), concat index): ascending distance, exact
// ties resolved by position, beam first. mono_key is the order-isomorphic
// uint32 of the float with -0.0 taken as +0.0 (beam_merge.py:66). The output
// is bitwise that of the stable-sort oracle, ties included, for any beam.
//
// What bounds it on the H100: bytes, every distance (B·4(L + C)), the ids
// of live candidates and of output beam entries, and B·(9L + C) out. The
// candidate scan (step 2a) streams the distances with every row of a
// serving batch in flight at once, so a warp's shared memory is
// kept to 4·C bytes of list and 4·hash_slots(C) of hash (32 warps an SM at
// C = 720); what a row adds after the scan is the latency of its dedup,
// sort and output gathers, which the design keeps short: no block-wide
// barrier, no atomics in the scan, the sorts in registers.
//
// Design: one warp per row, several rows per block, no block-wide barrier.
//   1. The beam: its (key, index) pairs go to registers (striped, P/32 a
//      lane, P = next_pow2(max(L, 32))); one ballot a 32-entry step tests
//      that the keys ascend; a warp maximum gives the largest pair, `thr`:
//      a candidate at or above it can never rank below L.
//   2a. The candidates, 128 a step (4 a lane, 16-byte loads where the row
//      is aligned): `keep` is zeroed, and the live ones (not +inf) are
//      listed by position in index order (ballots and popc, no atomics).
//   2b. Keep-first dedup over the list, 32 a round in index order: within
//      a round the lowest lane of each finite id (__match_any_sync) is its
//      first occurrence; it is kept unless an earlier round put the id in
//      a shared-memory hash (sized for the row's finite count) or it is the
//      sentinel n after a non-finite candidate. Kept ids set `keep` and,
//      with `visited`, their bit (atomicOr). Kept and -inf candidates below
//      `thr` stay listed, in order. O(F) a row for F finite candidates.
//   3. Selection in registers: the survivors, P at a time, are bitonic-
//      sorted by shuffles (only the prefix that holds them) and folded into
//      the running best P: the least of a[i] and b[P-1-i] is bitonic, and
//      one bitonic merge sorts it.
//   4. The beam's pairs, bitonic-sorted first if step 1 found them out of
//      order (they carry their indices, so the order is stable), are folded
//      with the best P the same way: the first L pairs are the output. The
//      pairs are distinct, so the beam wins exact distance ties by its
//      lower index. Outputs are written coalesced.
//   A beam wider than the registers hold (L > 512, P = 512) takes steps 3-4
//   P output slots at a time: each chunk is the best P pairs above the last
//   chunk's largest, from batches of the beam's pairs and the survivors.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;          // rows a block (one warp each)
constexpr int kPerLane = 4;        // candidates a lane per step
constexpr int kStep = 32 * kPerLane;
constexpr uint32_t kInfBits = 0x7f800000u;
constexpr int kEmpty = INT_MIN;    // an unused hash slot; the id INT_MIN has slot H
constexpr unsigned kFull = 0xffffffffu;
constexpr uint64_t kNone = ~0ull;  // the pair that sorts after every real one
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kMaxN = 16;         // pairs a lane: wider beams go P = 512 at a time

__host__ __device__ inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}
// the sorted width of the selection, a multiple of 32
__host__ __device__ inline int merge_width(int L) { return next_pow2(L < 32 ? 32 : L); }
// hash slots for F ids: at most 0.8 full
__host__ __device__ inline int hash_slots(int F) { return next_pow2(F + F / 4 + 1); }
// a warp's shared memory, 16-byte aligned: room for the hash of C ids
// (H + 1 slots; slot H marks the id INT_MIN), then the list (C positions)
__host__ __device__ inline size_t hash_bytes(int C) {
  return ((static_cast<size_t>(hash_slots(C)) + 1) * sizeof(int) + 15) / 16 * 16;
}
__host__ __device__ inline size_t warp_bytes(int C) {
  return hash_bytes(C) + (static_cast<size_t>(C) * sizeof(int) + 15) / 16 * 16;
}

__device__ __forceinline__ uint32_t mono_key(float d) {
  if (d == 0.f) d = 0.f;  // -0.0 -> +0.0
  const uint32_t bits = __float_as_uint(d);
  return (bits >> 31) ? ~bits : (bits | 0x80000000u);
}

// (key, concat index): the order of the stable sort as one integer
__device__ __forceinline__ uint64_t pair_of(float d, int e) {
  return (static_cast<uint64_t>(mono_key(d)) << 32) | static_cast<uint32_t>(e);
}

__device__ __forceinline__ uint64_t min64(uint64_t a, uint64_t b) { return a < b ? a : b; }
__device__ __forceinline__ uint64_t max64(uint64_t a, uint64_t b) { return a < b ? b : a; }

// A warp's P = 32·N pairs in registers, striped: element i = 32·e + lane is
// a[e] of that lane. Partners at a distance below 32 are exchanged by
// shuffles, farther ones are in the lane's own registers. One
// compare-exchange stage on the first 32·M pairs:
template <int M, int N>
__device__ __forceinline__ void bitonic_step(uint64_t (&a)[N], int k, int j, int lane) {
  if (j < 32) {
#pragma unroll
    for (int e = 0; e < M; ++e) {
      const uint64_t y = __shfl_xor_sync(kFull, a[e], j);
      const bool up = k == 0 || ((32 * e + lane) & k) == 0;  // k = 0: ascending
      a[e] = (((lane & j) == 0) == up) ? min64(a[e], y) : max64(a[e], y);
    }
  } else {
#pragma unroll
    for (int f = 1; f < M; f <<= 1) {  // f = j / 32, every index known at compile time
      if (f != (j >> 5)) continue;
#pragma unroll
      for (int e = 0; e < M; ++e) {
        if (e & f) continue;
        const bool up = k == 0 || ((32 * e + lane) & k) == 0;
        const uint64_t x = a[e], y = a[e | f];
        a[e] = up ? min64(x, y) : max64(x, y);
        a[e | f] = up ? max64(x, y) : min64(x, y);
      }
    }
  }
}

// bitonic sort of the first 32·M pairs, ascending
template <int M, int N>
__device__ __forceinline__ void warp_sort(uint64_t (&a)[N], int lane) {
#pragma unroll
  for (int k = 2; k <= 32 * M; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) bitonic_step<M>(a, k, j, lane);
}

// sorts a whose pairs past the first `live` are kNone: only the narrowest
// power-of-two prefix that holds them is sorted (the rest is in place)
template <int N>
__device__ __forceinline__ void warp_sort_live(uint64_t (&a)[N], int live, int lane) {
  constexpr int M2 = N < 2 ? N : 2, M4 = N < 4 ? N : 4, M8 = N < 8 ? N : 8;
  if (live <= 32) warp_sort<1>(a, lane);
  else if (live <= 64) warp_sort<M2>(a, lane);
  else if (live <= 128) warp_sort<M4>(a, lane);
  else if (live <= 256) warp_sort<M8>(a, lane);
  else warp_sort<N>(a, lane);
}

// the 32·N least of two ascending sequences, ascending, into a: the least
// of a[i] and b[32·N - 1 - i] form a bitonic sequence, then one merge
template <int N>
__device__ __forceinline__ void warp_fold(uint64_t (&a)[N], const uint64_t (&b)[N], int lane) {
#pragma unroll
  for (int e = 0; e < N; ++e) a[e] = min64(a[e], __shfl_sync(kFull, b[N - 1 - e], 31 - lane));
#pragma unroll
  for (int j = 16 * N; j > 0; j >>= 1) bitonic_step<N>(a, 0, j, lane);
}

// inserts id; true when it was not there yet
__device__ __forceinline__ bool hash_insert(int* hash, int H, int log_h, int id) {
  if (id == kEmpty) return atomicExch(&hash[H], 1) == 0;
  int s = static_cast<int>((static_cast<uint32_t>(id) * 2654435761u) >> (32 - log_h));
  for (;;) {
    const int old = atomicCAS(&hash[s], kEmpty, id);
    if (old == kEmpty) return true;
    if (old == id) return false;
    s = (s + 1) & (H - 1);
  }
}

template <int N>  // P = 32·N >= L
__global__ void __launch_bounds__(kWarps * 32) beam_merge_kernel(
    const float* __restrict__ beam_d, const int* __restrict__ beam_ids,
    const uint8_t* __restrict__ beam_exp, const float* __restrict__ cand_d,
    const int* __restrict__ cand_ids, int B, int L, int C, int n,
    int* __restrict__ visited, int W, int vec, int* __restrict__ out_ids,
    float* __restrict__ out_d, uint8_t* __restrict__ out_exp,
    uint8_t* __restrict__ keep) {
  constexpr int P = 32 * N;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the whole warp: nothing below waits on the block
  unsigned char* mine = smem + warp * warp_bytes(C);
  int* hash = reinterpret_cast<int*>(mine);
  int* list = reinterpret_cast<int*>(mine + hash_bytes(C));
  const size_t bl = static_cast<size_t>(b) * L;
  const size_t bc = static_cast<size_t>(b) * C;
  const unsigned below = (1u << lane) - 1;

  // 1. the beam's pairs; are they ascending; the largest
  bool sorted = true;
  uint64_t thr = 0, bm[N];
  uint32_t last = 0;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const int i = 32 * e + lane;
    const float d = i < L ? beam_d[bl + i] : 0.f;
    const uint32_t k = i < L ? mono_key(d) : 0xffffffffu;
    uint32_t prev = __shfl_up_sync(kFull, k, 1);
    if (lane == 0) prev = last;
    sorted = __all_sync(kFull, prev <= k) && sorted;
    last = __shfl_sync(kFull, k, 31);
    bm[e] = i < L ? pair_of(d, i) : kNone;
    if (i < L) thr = max64(thr, bm[e]);
  }
  if constexpr (N == kMaxN)  // a beam wider than the registers: the rest of it
    for (int i = P + lane; i < L; i += 32) thr = max64(thr, pair_of(beam_d[bl + i], i));
  for (int o = 16; o > 0; o >>= 1) thr = max64(thr, __shfl_xor_sync(kFull, thr, o));

  // 2a. the live candidates (not +inf) listed in index order; keep zeroed
  int first_nf = INT_MAX;  // the first non-finite candidate
  int count = 0;           // candidates listed
  int finite = 0;          // finite candidates (this lane's)
  for (int c0 = 0; c0 < C; c0 += kStep) {
    const int j0 = c0 + kPerLane * lane;
    const int nk = min(kPerLane, C - j0);  // candidates of this lane (<= 0 past C)
    float d[kPerLane];
    if (vec && nk == kPerLane) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(cand_d + bc + j0));
      d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
      *reinterpret_cast<uchar4*>(keep + bc + j0) = make_uchar4(0, 0, 0, 0);
    } else {
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        d[k] = k < nk ? cand_d[bc + j0 + k] : 0.f;
        if (k < nk) keep[bc + j0 + k] = 0;
      }
    }
    unsigned live = 0;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      if (k < nk && !isfinite(d[k])) first_nf = min(first_nf, j0 + k);
      finite += k < nk && isfinite(d[k]);
      if (k < nk && __float_as_uint(d[k]) != kInfBits) live |= 1u << k;
    }
    // ordered compaction: the pairs of lower lanes first, then this lane's
    int at = count, total = 0;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const unsigned m = __ballot_sync(kFull, (live >> k) & 1);
      at += __popc(m & below);
      total += __popc(m);
    }
#pragma unroll
    for (int k = 0; k < kPerLane; ++k)
      if ((live >> k) & 1) list[at++] = j0 + k;
    count += total;
  }
  first_nf = __reduce_min_sync(kFull, first_nf);
  // the hash, sized for this row's finite candidates
  const int H = hash_slots(__reduce_add_sync(kFull, finite));
  const int log_h = __ffs(H) - 1;
  if (H >= 4) {
    for (int s = 4 * lane; s < H; s += 128)
      *reinterpret_cast<int4*>(hash + s) = make_int4(kEmpty, kEmpty, kEmpty, kEmpty);
  } else if (lane < H) {
    hash[lane] = kEmpty;
  }
  if (lane == 0) hash[H] = 0;
  __syncwarp();

  // 2b. keep-first dedup over the list, 32 in index order a round: within
  // a round the lowest lane of each id (match) is its first; it is new
  // unless an earlier round put the id in the hash. Survivors (kept, or
  // -inf) below thr are compacted in place; keep and visited bits are set.
  int listed = 0;
  int j_next = 0, id_next = 0;  // the next round's, loaded a round ahead
  float d_next = 0.f;
  if (count > 0) {
    j_next = lane < count ? list[lane] : 0;
    d_next = __ldg(cand_d + bc + j_next);
    id_next = __ldg(cand_ids + bc + j_next);
  }
  for (int r0 = 0; r0 < count; r0 += 32) {
    const int i = r0 + lane;
    const int j = j_next, id = id_next;
    const float d = d_next;
    if (r0 + 32 < count) {  // ahead of this round's writes, which stay below r0 + 32
      j_next = i + 32 < count ? list[i + 32] : 0;
      d_next = __ldg(cand_d + bc + j_next);
      id_next = __ldg(cand_ids + bc + j_next);
    }
    const uint64_t p = i < count ? pair_of(d, L + j) : kNone;
    const bool fin = i < count && isfinite(d);
    const unsigned fin_lanes = __ballot_sync(kFull, fin);
    bool kept = false;
    if (fin) {
      const unsigned same = __match_any_sync(fin_lanes, id);
      kept = (same & below) == 0 && hash_insert(hash, H, log_h, id) &&
             !(id == n && first_nf < j);
      if (kept) {
        keep[bc + j] = 1;
        if (visited != nullptr) {
          const int v = min(max(id, 0), n - 1);
          atomicOr(visited + static_cast<size_t>(b) * W + (v >> 5), 1 << (v & 31));
        }
      }
    }
    const bool surv = (kept || (i < count && !fin)) && p < thr;
    const unsigned m = __ballot_sync(kFull, surv);
    if (surv) list[listed + __popc(m & below)] = j;
    listed += __popc(m);
  }
  count = listed;
  __syncwarp();

  // output slot s takes the entry of concat index i
  const auto put = [&](int s, int i) {
    if (i < L) {
      out_d[bl + s] = beam_d[bl + i];
      out_ids[bl + s] = beam_ids[bl + i];
      out_exp[bl + s] = beam_exp[bl + i];
    } else {
      const float dj = cand_d[bc + i - L];
      out_d[bl + s] = dj;
      out_ids[bl + s] = cand_ids[bc + i - L];
      out_exp[bl + s] = isfinite(dj) ? 0 : 1;  // kept: 0; -inf: 1
    }
  };
  uint64_t best[N], part[N];

  // 3-4, a beam wider than the registers (L > P): the output P slots at a
  // time, each chunk the best P pairs above the last chunk's largest, from
  // batches of the beam's pairs and then the survivors, sorted and folded
  if constexpr (N == kMaxN) {
    if (L > P) {
      const int total = L + count;
      uint64_t lo = 0;
      for (int s0 = 0; s0 < L; s0 += P) {
        for (int t0 = 0; t0 < total; t0 += P) {
#pragma unroll
          for (int e = 0; e < N; ++e) {
            const int t = t0 + 32 * e + lane;
            uint64_t p = kNone;
            if (t < L) {
              p = pair_of(__ldg(beam_d + bl + t), t);
            } else if (t < total) {
              const int j = list[t - L];
              p = pair_of(__ldg(cand_d + bc + j), L + j);
            }
            part[e] = s0 == 0 || p > lo ? p : kNone;
          }
          warp_sort<N>(part, lane);
          if (t0 == 0) {
#pragma unroll
            for (int e = 0; e < N; ++e) best[e] = part[e];
          } else {
            warp_fold(best, part, lane);
          }
        }
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const int s = s0 + 32 * e + lane;
          if (s < L) put(s, static_cast<int>(static_cast<uint32_t>(best[e])));
        }
        lo = __shfl_sync(kFull, best[N - 1], 31);  // a real pair: L - s0 > P remain
      }
      return;
    }
  }

  // 3. the best P survivors, batch by batch, in registers
  for (int s0 = 0; s0 < count; s0 += P) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int i = s0 + 32 * e + lane;
      const int j = i < count ? list[i] : 0;
      part[e] = i < count ? pair_of(__ldg(cand_d + bc + j), L + j) : kNone;
    }
    warp_sort_live(part, count - s0, lane);
    if (s0 == 0) {
#pragma unroll
      for (int e = 0; e < N; ++e) best[e] = part[e];
    } else {
      warp_fold(best, part, lane);
    }
  }
  if (count == 0) {
#pragma unroll
    for (int e = 0; e < N; ++e) best[e] = kNone;
  }

  // 4. the beam's pairs (sorted if they were not), merged with the survivors
  if (!sorted) warp_sort<N>(bm, lane);
  warp_fold(best, bm, lane);
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const int s = 32 * e + lane;
    if (s >= L) break;
    put(s, static_cast<int>(static_cast<uint32_t>(best[e])));
  }
}

template <int N>
int launch(const float* beam_d, const int* beam_ids, const uint8_t* beam_exp,
           const float* cand_d, const int* cand_ids, int B, int L, int C, int n,
           int* visited, int W, int* out_ids, float* out_d, uint8_t* out_exp,
           uint8_t* keep, cudaStream_t stream) {
  const size_t per_warp = warp_bytes(C);
  if (per_warp > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  int warps = kWarps;
  while (warps > 1 && warps * per_warp > kMaxSmem) warps >>= 1;
  const size_t smem = warps * per_warp;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        beam_merge_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const uintptr_t rows = reinterpret_cast<uintptr_t>(cand_d) | reinterpret_cast<uintptr_t>(cand_ids);
  const int vec = C % kPerLane == 0 && rows % 16 == 0 && reinterpret_cast<uintptr_t>(keep) % 4 == 0;
  beam_merge_kernel<N><<<(B + warps - 1) / warps, warps * 32, smem, stream>>>(
      beam_d, beam_ids, beam_exp, cand_d, cand_ids, B, L, C, n, visited, W, vec,
      out_ids, out_d, out_exp, keep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The interface: 2 = takes the visited bitmap (nullptr: leave it alone).
extern "C" int beam_merge_abi() { return 2; }

extern "C" int beam_merge(const float* beam_d, const int* beam_ids,
                          const uint8_t* beam_exp, const float* cand_d,
                          const int* cand_ids, int B, int L, int C, int n,
                          int* visited, int W, int* out_ids, float* out_d,
                          uint8_t* out_exp, uint8_t* keep, void* stream) {
  if (B == 0) return 0;
  if (L <= 0 || C < 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (merge_width(L) / 32) {
    case 1: return launch<1>(beam_d, beam_ids, beam_exp, cand_d, cand_ids, B, L, C, n, visited, W, out_ids, out_d, out_exp, keep, s);
    case 2: return launch<2>(beam_d, beam_ids, beam_exp, cand_d, cand_ids, B, L, C, n, visited, W, out_ids, out_d, out_exp, keep, s);
    case 4: return launch<4>(beam_d, beam_ids, beam_exp, cand_d, cand_ids, B, L, C, n, visited, W, out_ids, out_d, out_exp, keep, s);
    case 8: return launch<8>(beam_d, beam_ids, beam_exp, cand_d, cand_ids, B, L, C, n, visited, W, out_ids, out_d, out_exp, keep, s);
    default: return launch<kMaxN>(beam_d, beam_ids, beam_exp, cand_d, cand_ids, B, L, C, n, visited, W, out_ids, out_d, out_exp, keep, s);
  }
}
