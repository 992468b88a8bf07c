// Gather-fused label test + visited test + squared distance, for Hopper.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   * filter_dist_gather_packed_pallas (repro/kernels/filter_dist.py:345,
//     body _gather_packed_kernel_body) -- the search loop's scorer: the label
//     of candidate j is the packed word pair plabels[cur_ids[b, j / E], j % E];
//   * filter_dist_gather_pallas (repro/kernels/filter_dist.py:219, body
//     _gather_kernel_body) -- the planner's BRUTE_VALID scan: the label is the
//     pre-gathered int32 rectangle labels[b, j].
// Both share one epilogue (label test, id >= 0, visited bit, cached-norm
// distance), as the Pallas kernels share _masked_distance.
//
// out[b, j] = norms[id] - 2 * scale[id] * dot(q[b], table[id]) + |q[b]|^2
//             where the label rectangle contains the state (a, c), id >= 0 and
//             bit (id & 31) of visited[b, id >> 5] is clear; +inf otherwise.
// A padding id (-1) is clipped to row 0 for every fetch and masked by the raw
// id, as in filter_dist.py:244,378.
//
// What bounds it on the H100: memory. Per candidate it reads one row of 4*D
// (f32) or D (int8) bytes from a table far larger than the 50 MB L2, plus
// about 24-36 bytes of ids, labels, norm, scale and visited word, and does
// 2*D multiply-adds: well below the card's ops-per-byte balance point, in
// f64 too (see Numerics).
//
// Numerics: the dot product q.c and |q|^2 are summed in f64 (every f32 or
// int8 product is exact in f64) and rounded once to f32; the rest is the
// reference's f32 arithmetic, operation by operation. The plain version does
// the same, so kernel and plain version agree to the bit but for the rare sum
// that lands within ~1e-16 of an f32 rounding boundary, whatever order each
// sums in -- which keeps a search on the card on the same trajectory as on
// the CPU. Against the f32 reference the difference is the f32 sum's own
// rounding error.
//
// Design: one block of 8 warps per (query, tile of 1024 candidates) -- one
// block per query on the main path's widths -- so the query row is read from
// device memory once, staged in shared memory, and |q|^2 reduced there once.
// Each warp takes 32 candidates at a time, one per lane: the lanes read the
// ids, label words and visited words of their candidates together (the id
// and label reads coalesce) and apply the cheap tests. A candidate that fails
// them costs no row read at all, which on the search path (most candidates
// already visited or label-invalid) removes most of the row traffic. The warp
// then scores its survivors one by one (a ballot of the lanes that passed):
// all 32 lanes read the row with 16-byte loads, neighbouring lanes on
// neighbouring addresses, and reduce the dot product with shuffles. int8
// rows are widened and the dot product is multiplied by the row's scale
// (filter_dist.py:167-170). A later PR can pipeline the row fetches with
// cp.async.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kTile = 1024;  // candidates per block

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Per-lane partial dot product of one table row with the staged query.
// vec: the row and the query may be read 16 bytes at a time.
__device__ __forceinline__ double row_dot(const float* __restrict__ row,
                                          const float* __restrict__ qs, int D,
                                          bool vec, int lane) {
  double acc = 0.0;
  int done = 0;
  if (vec) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const float4* q4 = reinterpret_cast<const float4*>(qs);
    const int n4 = D >> 2;
    for (int i = lane; i < n4; i += 32) {
      const float4 v = __ldg(r4 + i);
      const float4 w = q4[i];
      acc += static_cast<double>(v.x) * w.x;
      acc += static_cast<double>(v.y) * w.y;
      acc += static_cast<double>(v.z) * w.z;
      acc += static_cast<double>(v.w) * w.w;
    }
    done = n4 << 2;
  }
  for (int i = done + lane; i < D; i += 32)
    acc += static_cast<double>(__ldg(row + i)) * qs[i];
  return acc;
}

__device__ __forceinline__ double row_dot(const int8_t* __restrict__ row,
                                          const float* __restrict__ qs, int D,
                                          bool vec, int lane) {
  double acc = 0.0;
  int done = 0;
  if (vec) {
    const int4* r16 = reinterpret_cast<const int4*>(row);
    const int n16 = D >> 4;
    for (int i = lane; i < n16; i += 32) {
      const int4 v = __ldg(r16 + i);
      const int8_t* p = reinterpret_cast<const int8_t*>(&v);
      const float* w = qs + (i << 4);
#pragma unroll
      for (int k = 0; k < 16; ++k) acc += static_cast<double>(p[k]) * w[k];
    }
    done = n16 << 4;
  }
  for (int i = done + lane; i < D; i += 32)
    acc += static_cast<double>(row[i]) * qs[i];
  return acc;
}

struct Args {
  const void* table;
  const float* norms;
  const float* scales;   // nullptr: no dequant scale
  const float* q;        // [B, D]
  const int* cand_ids;   // [B, C]
  const int* plabels;    // packed: [n, E, 2] word pairs
  const int* cur_ids;    // packed: [B, M] expanded nodes
  const int* labels;     // int32 layout: [B, C, 4] rectangles
  const int* state;      // [B, 2]
  const int* visited;    // [B, W] bitmap words
  float* out;            // [B, C]
  int n, D, B, C, M, E, W, tiles, vec;
};

template <typename T, bool kPacked>
__global__ void __launch_bounds__(kWarps * 32) filter_dist_kernel(Args p) {
  extern __shared__ float4 smem[];
  float* qs = reinterpret_cast<float*>(smem);
  __shared__ double red[kWarps];
  const int b = blockIdx.x / p.tiles;
  const int tile = blockIdx.x - b * p.tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const float* qb = p.q + static_cast<size_t>(b) * p.D;
  double part = 0.0;
  for (int i = threadIdx.x; i < p.D; i += blockDim.x) {
    const float v = qb[i];
    qs[i] = v;
    part += static_cast<double>(v) * v;
  }
  part = warp_sum(part);
  if (lane == 0) red[warp] = part;
  __syncthreads();
  double qn64 = 0.0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) qn64 += red[w];
  const float qn = static_cast<float>(qn64);

  const int a = p.state[2 * b], c = p.state[2 * b + 1];
  const T* table = static_cast<const T*>(p.table);
  const int j_end = min((tile + 1) * kTile, p.C);
  for (int base = tile * kTile + warp * 32; base < j_end; base += kWarps * 32) {
    // 1. one candidate per lane: the cheap tests
    const int j = base + lane;
    const size_t bj = static_cast<size_t>(b) * p.C + j;
    int safe = 0;
    bool ok = false;
    if (j < j_end) {
      const int id = p.cand_ids[bj];
      safe = min(max(id, 0), p.n - 1);
      int l, r, lb, le;
      if (kPacked) {
        const int m = j / p.E;
        const int e = j - m * p.E;
        const int cur = min(max(p.cur_ids[b * p.M + m], 0), p.n - 1);
        const int* w = p.plabels + (static_cast<size_t>(cur) * p.E + e) * 2;
        const uint32_t w0 = static_cast<uint32_t>(w[0]);
        const uint32_t w1 = static_cast<uint32_t>(w[1]);
        l = w0 & 0xFFFFu;
        r = w0 >> 16;
        lb = w1 & 0xFFFFu;
        le = w1 >> 16;
      } else {
        const int* rect = p.labels + bj * 4;
        l = rect[0];
        r = rect[1];
        lb = rect[2];
        le = rect[3];
      }
      const uint32_t word = static_cast<uint32_t>(
          p.visited[static_cast<size_t>(b) * p.W + (safe >> 5)]);
      const bool seen = (word >> (max(id, 0) & 31)) & 1u;
      ok = l <= a && a <= r && lb <= c && c <= le && id >= 0 && !seen;
      if (!ok) p.out[bj] = __int_as_float(0x7f800000);
    }
    // 2. the whole warp scores each survivor's row in turn
    unsigned live = __ballot_sync(0xffffffffu, ok);
    while (live) {
      const int src = __ffs(live) - 1;
      live &= live - 1;
      const int row = __shfl_sync(0xffffffffu, safe, src);
      const float dot = static_cast<float>(warp_sum(
          row_dot(table + static_cast<size_t>(row) * p.D, qs, p.D, p.vec != 0, lane)));
      if (lane == src) {
        const float cross = p.scales ? __fmul_rn(dot, p.scales[row]) : dot;
        // (norm - 2 * cross) + qn, unfused, in the reference's order
        p.out[bj] = __fadd_rn(__fsub_rn(p.norms[row], __fmul_rn(2.f, cross)), qn);
      }
    }
  }
}

template <bool kPacked>
int launch(const Args& p, int is_int8, void* stream) {
  if (p.B == 0 || p.C == 0) return 0;
  const size_t smem = ((static_cast<size_t>(p.D) + 3) / 4) * sizeof(float4);
  const dim3 grid(p.B * p.tiles), block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_int8)
    filter_dist_kernel<int8_t, kPacked><<<grid, block, smem, s>>>(p);
  else
    filter_dist_kernel<float, kPacked><<<grid, block, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int filter_dist_gather_packed(
    const void* table, int is_int8, int n, int D, const float* norms,
    const float* scales, const float* q, const int* cur_ids, int M,
    const int* cand_ids, int B, int C, const int* plabels, int E,
    const int* state, const int* visited, int W, int vec, float* out,
    void* stream) {
  Args p{table, norms, scales, q, cand_ids, plabels, cur_ids, nullptr, state,
         visited, out, n, D, B, C, M, E, W, (C + kTile - 1) / kTile, vec};
  return launch<true>(p, is_int8, stream);
}

extern "C" int filter_dist_gather(
    const void* table, int is_int8, int n, int D, const float* norms,
    const float* scales, const float* q, const int* cand_ids, int B, int C,
    const int* labels, const int* state, const int* visited, int W, int vec,
    float* out, void* stream) {
  Args p{table, norms, scales, q, cand_ids, nullptr, nullptr, labels, state,
         visited, out, n, D, B, C, 1, 1, W, (C + kTile - 1) / kTile, vec};
  return launch<false>(p, is_int8, stream);
}
