// Label test + squared distance, for Hopper: the port's three scorers.
//
// Replaces three Pallas TPU kernels of the JAX package:
//   * filter_dist_gather_packed_pallas (repro/kernels/filter_dist.py:345,
//     body _gather_packed_kernel_body) -- the search loop's scorer: the label
//     of candidate j is the packed word pair plabels[cur_ids[b, j / E], j % E];
//   * filter_dist_gather_pallas (repro/kernels/filter_dist.py:219, body
//     _gather_kernel_body) -- the planner's BRUTE_VALID scan, the int32-label
//     search branch and the constructor's broad search: the label is the
//     pre-gathered int32 rectangle labels[b, j];
//   * filter_dist_pallas (repro/kernels/filter_dist.py:86, body
//     _filter_dist_kernel) -- the unfused search branch's scorer: the rows
//     come pre-gathered as a dense [B, E, D] tensor, the rectangles as
//     [B, E, 4], there is no visited bitmap, and |c|^2 is recomputed from the
//     row instead of read from a cached norm.
// All three share one structure: the cheap tests (label, id >= 0, visited bit)
// for 32 candidates at a time, one per lane, before any row is read; then the
// whole warp scores each survivor, as the Pallas kernels share
// _masked_distance.
//
// Gather scorers (B1, B3):
// out[b, j] = norms[id] - 2 * scale[id] * dot(q[b], table[id]) + |q[b]|^2
//             where the label rectangle contains the state (a, c), id >= 0 and
//             bit (id & 31) of visited[b, id >> 5] is clear; +inf otherwise.
// A padding id (-1) is clipped to row 0 for every fetch and masked by the raw
// id, as in filter_dist.py:244,378.
// Dense scorer (B4):
// out[b, j] = |cand[b, j]|^2 - 2 * dot(q[b], cand[b, j]) + |q[b]|^2
//             where the label rectangle contains (a, c) and id >= 0.
//
// What bounds them on the H100: memory. Per candidate they read one row of
// 4*D (f32) or D (int8) bytes, from a table far larger than the 50 MB L2 (or,
// for B4, from a dense tensor of B*E rows), plus about 24-36 bytes of ids,
// labels, norm, scale and visited word, and do 2*D (B4: 4*D) multiply-adds:
// well below the card's ops-per-byte balance point, in f64 too (see Numerics).
//
// Numerics: every sum (q.c, |q|^2, and B4's |c|^2) is taken in f64 (every f32
// or int8 product is exact in f64) in one fixed order (row_dot: lane l adds
// its elements in turn, then a butterfly across the lanes) and rounded once to
// f32; the rest is the reference's f32 arithmetic, operation by operation. The
// plain versions (ref.warp_dot) sum in the same order, so kernel and plain
// version agree to the bit, and a search keeps one trajectory on the card and
// on the CPU. Against the f32 reference the difference is the f32 sum's own
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

// Per-lane partial dot product of one table row with the staged query, in
// one fixed order whatever the row's alignment: lane l adds the products of
// elements 32*kW*k + kW*l + j, k ascending, j = 0..kW-1, with kW = 4 for f32
// rows and 16 for int8 rows (one 16-byte load each when vec: D a multiple of
// kW and the row 16-byte aligned; else the same elements one by one). warp_sum
// then adds the lanes as a butterfly. ref.warp_dot(x, y, width=kW) repeats the
// order, so kernel and plain version agree to the bit. Plain loads, no __ldg:
// |q|^2 runs this on the query row in shared memory.
__device__ __forceinline__ double row_dot(const float* __restrict__ row,
                                          const float* __restrict__ qs, int D,
                                          bool vec, int lane) {
  double acc = 0.0;
  for (int e = 4 * lane; e < D; e += 128) {
    if (vec) {
      const float4 v = *reinterpret_cast<const float4*>(row + e);
      const float4 w = *reinterpret_cast<const float4*>(qs + e);
      acc += static_cast<double>(v.x) * w.x;
      acc += static_cast<double>(v.y) * w.y;
      acc += static_cast<double>(v.z) * w.z;
      acc += static_cast<double>(v.w) * w.w;
    } else {
      for (int j = e; j < min(e + 4, D); ++j)
        acc += static_cast<double>(row[j]) * qs[j];
    }
  }
  return acc;
}

__device__ __forceinline__ double row_dot(const int8_t* __restrict__ row,
                                          const float* __restrict__ qs, int D,
                                          bool vec, int lane) {
  double acc = 0.0;
  for (int e = 16 * lane; e < D; e += 512) {
    if (vec) {
      const int4 v = *reinterpret_cast<const int4*>(row + e);
      const int8_t* p = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int k = 0; k < 16; ++k) acc += static_cast<double>(p[k]) * qs[e + k];
    } else {
      for (int j = e; j < min(e + 16, D); ++j)
        acc += static_cast<double>(row[j]) * qs[j];
    }
  }
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
  __shared__ float qn_shared;
  const int b = blockIdx.x / p.tiles;
  const int tile = blockIdx.x - b * p.tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const float* qb = p.q + static_cast<size_t>(b) * p.D;
  for (int i = threadIdx.x; i < p.D; i += blockDim.x) qs[i] = qb[i];
  __syncthreads();
  if (warp == 0) {   // |q|^2 in row_dot's order (shared memory is aligned)
    const double qq = warp_sum(row_dot(qs, qs, p.D, (p.D & 3) == 0, lane));
    if (lane == 0) qn_shared = static_cast<float>(qq);
  }
  __syncthreads();
  const float qn = qn_shared;

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

// B4's sums: the f32 row_dot's order for x.y and x.x together, so the row is
// read once.
__device__ __forceinline__ void lane_dots(const float* __restrict__ x,
                                          const float* __restrict__ y, int D,
                                          bool vec, int lane, double& xy,
                                          double& xx) {
  xy = 0.0;
  xx = 0.0;
  for (int e = 4 * lane; e < D; e += 128) {
    if (vec) {
      const float4 a = *reinterpret_cast<const float4*>(x + e);
      const float4 w = *reinterpret_cast<const float4*>(y + e);
      xy += static_cast<double>(a.x) * w.x;
      xx += static_cast<double>(a.x) * a.x;
      xy += static_cast<double>(a.y) * w.y;
      xx += static_cast<double>(a.y) * a.y;
      xy += static_cast<double>(a.z) * w.z;
      xx += static_cast<double>(a.z) * a.z;
      xy += static_cast<double>(a.w) * w.w;
      xx += static_cast<double>(a.w) * a.w;
    } else {
      for (int j = e; j < min(e + 4, D); ++j) {
        const float a = x[j];
        xy += static_cast<double>(a) * y[j];
        xx += static_cast<double>(a) * a;
      }
    }
  }
}

struct DenseArgs {
  const float* q;        // [B, D]
  const float* cand;     // [B, E, D]
  const int* labels;     // [B, E, 4]
  const int* state;      // [B, 2]
  const int* cand_ids;   // [B, E]
  float* out;            // [B, E]
  int B, E, D, tiles, vec;
};

__global__ void __launch_bounds__(kWarps * 32) filter_dist_dense_kernel(DenseArgs p) {
  extern __shared__ float4 smem[];
  float* qs = reinterpret_cast<float*>(smem);
  __shared__ float qn_shared;
  const int b = blockIdx.x / p.tiles;
  const int tile = blockIdx.x - b * p.tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const float* qb = p.q + static_cast<size_t>(b) * p.D;
  for (int i = threadIdx.x; i < p.D; i += blockDim.x) qs[i] = qb[i];
  __syncthreads();
  if (warp == 0) {   // |q|^2 in row_dot's order (shared memory is aligned)
    const double qq = warp_sum(row_dot(qs, qs, p.D, (p.D & 3) == 0, lane));
    if (lane == 0) qn_shared = static_cast<float>(qq);
  }
  __syncthreads();
  const float qn = qn_shared;

  const int a = p.state[2 * b], c = p.state[2 * b + 1];
  const int j_end = min((tile + 1) * kTile, p.E);
  for (int base = tile * kTile + warp * 32; base < j_end; base += kWarps * 32) {
    // 1. one candidate per lane: label and id, no row read
    const int j = base + lane;
    const size_t bj = static_cast<size_t>(b) * p.E + j;
    bool ok = false;
    if (j < j_end) {
      const int* rect = p.labels + bj * 4;
      ok = rect[0] <= a && a <= rect[1] && rect[2] <= c && c <= rect[3] &&
           p.cand_ids[bj] >= 0;
      if (!ok) p.out[bj] = __int_as_float(0x7f800000);
    }
    // 2. the whole warp scores each survivor's row in turn
    unsigned live = __ballot_sync(0xffffffffu, ok);
    while (live) {
      const int src = __ffs(live) - 1;
      live &= live - 1;
      const size_t row = static_cast<size_t>(b) * p.E + base + src;
      double xy, xx;
      lane_dots(p.cand + row * p.D, qs, p.D, p.vec != 0, lane, xy, xx);
      xy = warp_sum(xy);
      xx = warp_sum(xx);
      if (lane == src) {
        const float cross = static_cast<float>(xy);
        const float cs = static_cast<float>(xx);
        // (cs - 2 * cross) + qn, unfused, in the reference's order
        p.out[row] = __fadd_rn(__fsub_rn(cs, __fmul_rn(2.f, cross)), qn);
      }
    }
  }
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

extern "C" int filter_dist_dense(const float* q, const float* cand, int B,
                                 int E, int D, const int* labels,
                                 const int* state, const int* cand_ids,
                                 int vec, float* out, void* stream) {
  if (B == 0 || E == 0) return 0;
  const int tiles = (E + kTile - 1) / kTile;
  DenseArgs p{q, cand, labels, state, cand_ids, out, B, E, D, tiles, vec};
  const size_t smem = ((static_cast<size_t>(D) + 3) / 4) * sizeof(float4);
  filter_dist_dense_kernel<<<dim3(B * tiles), dim3(kWarps * 32), smem,
                             static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
