// Label test + squared distance, for Hopper: the port's three scorers.
//
// Replaces three Pallas TPU kernels of the JAX package:
//   * filter_dist_gather_packed_pallas (repro/kernels/filter_dist.py:345,
//     body _gather_packed_kernel_body) -- the search loop's scorer (B1): the
//     label of candidate j is the packed word pair
//     plabels[cur_ids[b, j / E], j % E];
//   * filter_dist_gather_pallas (repro/kernels/filter_dist.py:219, body
//     _gather_kernel_body) -- the planner's BRUTE_VALID scan, the int32-label
//     search branch and the constructor's broad search (B3): the label is the
//     pre-gathered int32 rectangle labels[b, j];
//   * filter_dist_pallas (repro/kernels/filter_dist.py:86, body
//     _filter_dist_kernel) -- the unfused search branch's scorer (B4): the
//     rows come pre-gathered as a dense [B, E, D] tensor, the rectangles as
//     [B, E, 4], there is no visited bitmap, and |c|^2 is recomputed from the
//     row instead of read from a cached norm.
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
// Numerics: every sum (q.c, |q|^2, and B4's |c|^2) is taken in f64 (every f32
// or int8 product is exact in f64) in one fixed order and rounded once to
// f32: lane l of 32 adds the products of elements 32*kW*k + kW*l + j, k
// ascending, j = 0..kW-1 (kW = 4 for f32 rows, 16 for int8 rows, 4 for
// |q|^2), then the lanes are added as a butterfly. The rest is the
// reference's f32 arithmetic, operation by operation. The plain versions
// (ref.warp_dot) sum in the same order, so kernel and plain version agree to
// the bit, and a search keeps one trajectory on the card and on the CPU.
//
// What bounds the gather scorers on the H100. Per surviving candidate they
// read one row of 4*D (f32) or D (int8) bytes from a table far larger than
// the 50 MB L2, and do 2*D multiply-adds: far below the card's ops-per-byte
// balance point. But on the search path few candidates survive the cheap
// tests (about 17 of 720 a query), so a block has little row traffic and a
// chain of dependent loads: candidate id and expanded node, then the packed
// label words, then the visited word, then the row. Such a block waits on
// memory latency, not on bytes, and the card hides that latency only with
// many blocks resident on each SM. Where most candidates survive (the brute
// scan, the constructor's broad search) the rows' bytes bound it, and next
// the conversion of f32 values to f64, which runs at a quarter of the f64
// multiply-add rate.
//
// Design of B1/B3 (filter_dist_kernel): one block of 8 warps per (query,
// tile of up to 768 candidates); the wrapper picks the tile from (B, C) so
// that the grid holds several blocks per SM at every shape (ops.scorer_tile).
//   1. Tests in one pass. Each thread takes up to three candidates and issues
//      every load of a level before it uses any: ids, expanded nodes, int32
//      rectangles and its share of q at once; then the packed label words;
//      then -- only for candidates whose label passes -- the visited words.
//      A failure writes +inf at once; the survivors go to a shared-memory
//      list (a ballot, a prefix count and one shared atomic a warp). One
//      barrier publishes the list and q, staged in shared memory.
//   2. Rows in flight. Each warp takes every 8th survivor of the list, a
//      group of kRows rows at a time (1 f32 row, 2 int8 rows), and holds a
//      chunk of each row in registers (a lane's 6 16-byte pieces of 768 f32
//      elements, or 2 of 1024 int8 elements), all loads issued before the
//      first is used, with the rows' norms and scales; |q|^2 is summed while
//      they are on their way. Each q value is read from shared memory once
//      for the group. An int8 value widens to f64 without a conversion
//      instruction: biased by 128 it is the low word of the double
//      1.5 * 2^52 + u, less a constant (exact). Registers are capped (kMinBlocks) so 4 blocks (f32)
//      or 5 (int8) fit on an SM: the tests' latency is hidden across blocks,
//      and more rows in flight a warp (kRows 2 for f32) cost more there than
//      they win.
//   3. Each output slot is written once, by its own candidate, so the list's
//      order does not matter. Rows that 16-byte loads cannot take (D not a
//      multiple of one load, a table off 16-byte alignment) are read element
//      by element by the same kernel, one survivor a warp at a time.
//
// B4 (filter_dist_dense_kernel) keeps the first design: one block of 8 warps
// per (query, tile of 1024 candidates), the cheap tests for 32 candidates at
// a time, one per lane, then the whole warp scores each survivor in turn with
// 16-byte loads; its rows are dense, so every passing row is read.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kTile = 1024;          // B4: candidates per block
constexpr int kPerThread = 3;        // B1/B3: candidates a thread tests
constexpr int kMaxTile = kWarps * 32 * kPerThread;
constexpr int kQLoads = 3;           // q elements a thread loads with the tests
constexpr int kMaxSmem = 232448 - 64;  // dynamic shared memory a block can use
                                      // beside its static variables

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Per-lane partial dot product of an f32 row with the staged query, in the
// order above with kW = 4 (one 16-byte load each when vec, else the same
// elements one by one): B4's rows, and |q|^2 on the query row in shared
// memory (plain loads, no __ldg).
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

// Width of one 16-byte piece in elements of T.
template <typename T>
__host__ __device__ constexpr int width() { return 16 / static_cast<int>(sizeof(T)); }

// An int8 value stored biased by 128 (byte `k` of w ^ 0x80808080) as an
// exact double: 1.5 * 2^52 + u less 1.5 * 2^52 + 128, with no conversion
// instruction.
__device__ __forceinline__ double widen(uint32_t w, int k) {
  const uint32_t u = __byte_perm(w, 0u, 0x4440u | k);
  return __hiloint2double(0x43380000, static_cast<int>(u)) - 6755399441055872.0;
}

// Blocks an SM must hold at once: caps the registers at 64 a thread for f32
// rows, 51 for int8 rows (more blocks hide more of the tests' latency).
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 1 ? 5 : 4;

// Rows a warp holds in registers at once, the 16-byte pieces of a row a lane
// loads in one go (one chunk: 768 f32 or 1024 int8 elements), their type.
template <typename T> struct RowsInFlight;
template <> struct RowsInFlight<float> {
  static constexpr int rows = 1, pieces = 6;
  using Piece = float4;
};
template <> struct RowsInFlight<int8_t> {
  static constexpr int rows = 2, pieces = 2;
  using Piece = int4;
};

// Element i of a 16-byte piece as an exact double.
__device__ __forceinline__ double element(const float4& v, int i) {
  return static_cast<double>(i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w);
}
__device__ __forceinline__ double element(const int4& v, int i) {
  const int w = i >> 2 == 0 ? v.x : i >> 2 == 1 ? v.y : i >> 2 == 2 ? v.z : v.w;
  return widen(static_cast<uint32_t>(w) ^ 0x80808080u, i & 3);
}

// One lane's partial sum for rows that 16-byte loads cannot take (D not a
// multiple of width<T>(), a table off 16-byte alignment): the same elements
// one by one, in the same order.
template <typename T>
__device__ __forceinline__ double scalar_dot(const T* __restrict__ row,
                                             const float* __restrict__ qs, int D, int lane) {
  constexpr int kW = width<T>();
  double acc = 0.0;
  for (int e = kW * lane; e < D; e += 32 * kW)
    for (int j = e; j < min(e + kW, D); ++j) acc += static_cast<double>(row[j]) * qs[j];
  return acc;
}

// (norm - 2 * scale * dot) + qn, unfused, in the reference's order.
__device__ __forceinline__ float finish(double dot, float norm, float scale,
                                        bool scaled, float qn) {
  float cross = static_cast<float>(dot);
  if (scaled) cross = __fmul_rn(cross, scale);
  return __fadd_rn(__fsub_rn(norm, __fmul_rn(2.f, cross)), qn);
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
  int n, D, B, C, M, E, W;
  int vec;               // rows 16-byte aligned and D a multiple of width<T>()
  int tile;              // candidates per block, <= kMaxTile
};

// Dynamic shared memory: the query (whole 16-byte pieces), the survivor list.
size_t smem_bytes(const Args& p) {
  return (static_cast<size_t>(p.D) + 3) / 4 * 16 + static_cast<size_t>((p.tile + 1) & ~1) * 8;
}

template <typename T, bool kPacked>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks<T>) filter_dist_kernel(Args p) {
  extern __shared__ float4 smem[];
  __shared__ int s_count;
  constexpr int kW = width<T>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles = (p.C + p.tile - 1) / p.tile;
  const int b = blockIdx.x / tiles;
  const int j0 = (blockIdx.x - b * tiles) * p.tile;
  const int j1 = min(j0 + p.tile, p.C);
  float* qs = reinterpret_cast<float*>(smem);
  int2* list = reinterpret_cast<int2*>(smem + (p.D + 3) / 4);
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();

  // 1. the tests: every load of a level issued before any is used
  const size_t row0 = static_cast<size_t>(b) * p.C;
  const float* qb = p.q + static_cast<size_t>(b) * p.D;
  const int a = __ldg(p.state + 2 * b), c = __ldg(p.state + 2 * b + 1);
  int id[kPerThread], safe[kPerThread];
  bool ok[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int j = j0 + threadIdx.x + i * kWarps * 32;
    id[i] = j < j1 ? __ldg(p.cand_ids + row0 + j) : -1;
    ok[i] = false;
    if (j < j1) {
      if (kPacked) {
        const int m = j / p.E;
        const int e = j - m * p.E;
        const int cur = min(max(__ldg(p.cur_ids + b * p.M + m), 0), p.n - 1);
        const int* w = p.plabels + (static_cast<size_t>(cur) * p.E + e) * 2;
        const uint32_t w0 = static_cast<uint32_t>(__ldg(w));
        const uint32_t w1 = static_cast<uint32_t>(__ldg(w + 1));
        const int l = w0 & 0xFFFFu, r = w0 >> 16, lb = w1 & 0xFFFFu, le = w1 >> 16;
        ok[i] = l <= a && a <= r && lb <= c && c <= le;
      } else {
        const int* rect = p.labels + (row0 + j) * 4;
        ok[i] = __ldg(rect) <= a && a <= __ldg(rect + 1) && __ldg(rect + 2) <= c &&
                c <= __ldg(rect + 3);
      }
    }
  }
  // q into shared memory, its loads issued together with the tests'
  float qv[kQLoads];
#pragma unroll
  for (int u = 0; u < kQLoads; ++u) {
    const int i = threadIdx.x + u * kWarps * 32;
    qv[u] = i < p.D ? __ldg(qb + i) : 0.f;
  }
  uint32_t word[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    ok[i] = ok[i] && id[i] >= 0;
    safe[i] = min(max(id[i], 0), p.n - 1);
    word[i] = ok[i] ? static_cast<uint32_t>(__ldg(p.visited + static_cast<size_t>(b) * p.W +
                                                  (safe[i] >> 5)))
                    : 0u;
  }
#pragma unroll
  for (int u = 0; u < kQLoads; ++u) {
    const int i = threadIdx.x + u * kWarps * 32;
    if (i < p.D) qs[i] = qv[u];
  }
  for (int i = threadIdx.x + kQLoads * kWarps * 32; i < p.D; i += kWarps * 32) qs[i] = __ldg(qb + i);
  unsigned live[kPerThread];
  int total = 0;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int j = j0 + threadIdx.x + i * kWarps * 32;
    ok[i] = ok[i] && !((word[i] >> (id[i] & 31)) & 1u);
    if (j < j1 && !ok[i]) p.out[row0 + j] = __int_as_float(0x7f800000);
    live[i] = __ballot_sync(0xffffffffu, ok[i]);
    total += __popc(live[i]);
  }
  int base = 0;
  if (lane == 0 && total) base = atomicAdd(&s_count, total);
  base = __shfl_sync(0xffffffffu, base, 0);
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    if (ok[i])
      list[base + __popc(live[i] & below)] =
          make_int2(j0 + threadIdx.x + i * kWarps * 32, safe[i]);
    base += __popc(live[i]);
  }
  __syncthreads();

  // 2. every 8th survivor to each warp
  const int count = s_count;
  const int mine = warp < count ? (count - 1 - warp) / kWarps + 1 : 0;
  if (mine == 0) return;
  const T* table = static_cast<const T*>(p.table);
  const bool scaled = p.scales != nullptr;
  float qn = 0.f;
  if (!p.vec) {  // rows element by element, one at a time
    qn = static_cast<float>(warp_sum(row_dot(qs, qs, p.D, (p.D & 3) == 0, lane)));
    for (int k = 0; k < mine; ++k) {
      const int2 s = list[warp + k * kWarps];
      const double dot =
          warp_sum(scalar_dot(table + static_cast<size_t>(s.y) * p.D, qs, p.D, lane));
      if (lane == 0)
        p.out[row0 + s.x] = finish(dot, __ldg(p.norms + s.y),
                                   scaled ? __ldg(p.scales + s.y) : 1.f, scaled, qn);
    }
    return;
  }
  // kRows rows at a time, a chunk of kPieces 16-byte pieces a lane held in
  // registers: every load of a chunk issued before any is used, and each
  // q value read once for all kRows rows
  constexpr int kRows = RowsInFlight<T>::rows;
  constexpr int kPieces = RowsInFlight<T>::pieces;
  using Piece = typename RowsInFlight<T>::Piece;
  for (int k0 = 0; k0 < mine; k0 += kRows) {
    size_t at[kRows];
    bool has[kRows];
    int o_j = 0;                 // lane r keeps row r's output index, norm, scale
    float o_norm = 0.f, o_scale = 1.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      has[r] = k0 + r < mine;
      const int2 s = has[r] ? list[warp + (k0 + r) * kWarps] : make_int2(0, 0);
      at[r] = static_cast<size_t>(s.y) * p.D;
      if (lane == r && has[r]) {
        o_j = s.x;
        o_norm = __ldg(p.norms + s.y);
        if (scaled) o_scale = __ldg(p.scales + s.y);
      }
    }
    double acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0;
    for (int c0 = 0; c0 < p.D; c0 += 32 * kW * kPieces) {
      Piece v[kRows][kPieces];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int k = 0; k < kPieces; ++k) {
          const int e = c0 + kW * lane + 32 * kW * k;
          v[r][k] = has[r] && e < p.D
                        ? __ldg(reinterpret_cast<const Piece*>(table + at[r] + e))
                        : Piece{};
        }
      if (k0 == 0 && c0 == 0)    // |q|^2 while the first rows are on their way
        qn = static_cast<float>(warp_sum(row_dot(qs, qs, p.D, true, lane)));
#pragma unroll
      for (int k = 0; k < kPieces; ++k) {
        const int e = c0 + kW * lane + 32 * kW * k;
        if (e >= p.D) break;
#pragma unroll
        for (int h = 0; h < kW / 4; ++h) {
          const float4 w = *reinterpret_cast<const float4*>(qs + e + 4 * h);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            acc[r] += element(v[r][k], 4 * h) * w.x;
            acc[r] += element(v[r][k], 4 * h + 1) * w.y;
            acc[r] += element(v[r][k], 4 * h + 2) * w.z;
            acc[r] += element(v[r][k], 4 * h + 3) * w.w;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = warp_sum(acc[r]);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (lane == r && has[r]) p.out[row0 + o_j] = finish(acc[r], o_norm, o_scale, scaled, qn);
  }
}

template <bool kPacked>
int launch(const Args& p, int is_int8, void* stream) {
  if (p.B == 0 || p.C == 0) return 0;
  const size_t smem = smem_bytes(p);
  if (p.tile < 1 || p.tile > kMaxTile || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(p.B * ((p.C + p.tile - 1) / p.tile)), block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_int8) {
    auto* k = filter_dist_kernel<int8_t, kPacked>;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    k<<<grid, block, smem, s>>>(p);
  } else {
    auto* k = filter_dist_kernel<float, kPacked>;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    k<<<grid, block, smem, s>>>(p);
  }
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
    const int* state, const int* visited, int W, int vec, int tile, float* out,
    void* stream) {
  Args p{table, norms, scales, q, cand_ids, plabels, cur_ids, nullptr, state,
         visited, out, n, D, B, C, M, E, W, vec, tile};
  return launch<true>(p, is_int8, stream);
}

extern "C" int filter_dist_gather(
    const void* table, int is_int8, int n, int D, const float* norms,
    const float* scales, const float* q, const int* cand_ids, int B, int C,
    const int* labels, const int* state, const int* visited, int W, int vec,
    int tile, float* out, void* stream) {
  Args p{table, norms, scales, q, cand_ids, nullptr, nullptr, labels, state,
         visited, out, n, D, B, C, 1, 1, W, vec, tile};
  return launch<false>(p, is_int8, stream);
}

// The gather entry points' interface: 2 since they take `tile`. A build of
// an earlier source exports no such symbol; benchmarks that load other builds
// beside this one read it.
extern "C" int filter_dist_abi() { return 2; }

// The largest `tile` the gather entry points accept (ops.SCORER_MAX_TILE).
extern "C" int filter_dist_max_tile() { return kMaxTile; }

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
