// Tiled squared-L2 distance matrix, for Hopper.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   * l2dist_pallas (repro/kernels/l2dist.py:53, body _l2dist_kernel):
//     q [Bq, D] x c [Bc, D], f32 or f16, -> [Bq, Bc] f32;
//   * int8_l2dist_pallas (repro/kernels/int8dist.py:53, body _int8_kernel):
//     the same against int8 rows c_q, each dequantized by its f32 scale before
//     any product (the math stays f32: no int8 x int8 product).
// out[i, j] = |q_i|^2 - 2 * dot(q_i, c_j) + |c_j|^2, in the reference's order
// of the three terms.
//
// What bounds it on the H100: operations at the shapes that matter (2*D
// multiply-adds per output against 4*D bytes per row, reused across a whole
// tile), bytes only for thin blocks. The ports keep f32 on the CUDA cores
// (67 TFLOP/s); tensor cores would need TF32 or a narrower type, which the
// reference's f32 math does not allow.
//
// Design: the classic shared-memory tiling. One block of 256 threads computes
// a 64 x 64 output tile; the depth runs in chunks of 16: the block stages the
// 64 x 16 query and candidate slices in shared memory (converted to f32, int8
// rows times their scale), transposed so that a thread reads its 4 query
// values and 4 candidate values of one depth step as two 16-byte loads, and
// each thread accumulates a 4 x 4 block of outputs in registers. Threads 0-63
// also sum the squared query slice of their row, threads 64-127 that of their
// candidate row, so the norms need no second pass. Ragged edges (Bq, Bc, D
// not multiples of the tile) are zero-filled in shared memory and masked on
// the store. A later PR can double-buffer the slices with cp.async.
//
// Numerics: f32 sums in another order than the reference's and the plain
// version's, so the two agree within a tolerance that follows the norms (the
// expanded form cancels): |got - want| <= 1e-5 * (|q|^2 + |c|^2) + 1e-6.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileQ = 64, kTileC = 64, kDepth = 16, kThreads = 256;
constexpr int kPad = 4;  // row padding of the staged slices (keeps 16-byte rows)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

template <typename TQ, typename TC>
__global__ void __launch_bounds__(kThreads)
    l2dist_kernel(const TQ* __restrict__ q, const TC* __restrict__ c,
                  const float* __restrict__ scale, int Bq, int Bc, int D,
                  float* __restrict__ out) {
  __shared__ __align__(16) float qt[kDepth][kTileQ + kPad];
  __shared__ __align__(16) float ct[kDepth][kTileC + kPad];
  __shared__ float qn[kTileQ], cn[kTileC];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.y * kTileQ, col0 = blockIdx.x * kTileC;

  float acc[4][4] = {};
  float norm = 0.f;  // threads 0-63: |q_row|^2, threads 64-127: |c_row|^2
  for (int k0 = 0; k0 < D; k0 += kDepth) {
    for (int i = tid; i < kTileQ * kDepth; i += kThreads) {
      const int r = i / kDepth, kk = i - r * kDepth;
      const int gr = row0 + r, gk = k0 + kk;
      qt[kk][r] = (gr < Bq && gk < D) ? to_f32(q[static_cast<size_t>(gr) * D + gk]) : 0.f;
    }
    for (int i = tid; i < kTileC * kDepth; i += kThreads) {
      const int r = i / kDepth, kk = i - r * kDepth;
      const int gr = col0 + r, gk = k0 + kk;
      float v = 0.f;
      if (gr < Bc && gk < D) {
        v = to_f32(c[static_cast<size_t>(gr) * D + gk]);
        if (scale) v = __fmul_rn(v, scale[gr]);   // dequantize: c_q * scale
      }
      ct[kk][r] = v;
    }
    __syncthreads();
    if (tid < kTileQ) {
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) norm = fmaf(qt[kk][tid], qt[kk][tid], norm);
    } else if (tid < kTileQ + kTileC) {
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk)
        norm = fmaf(ct[kk][tid - kTileQ], ct[kk][tid - kTileQ], norm);
    }
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&qt[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ct[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (tid < kTileQ) qn[tid] = norm;
  else if (tid < kTileQ + kTileC) cn[tid - kTileQ] = norm;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= Bq) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = col0 + tx * 4 + j;
      if (cc < Bc)
        out[static_cast<size_t>(r) * Bc + cc] =
            __fadd_rn(__fsub_rn(qn[ty * 4 + i], __fmul_rn(2.f, acc[i][j])), cn[tx * 4 + j]);
    }
  }
}

template <typename TQ, typename TC>
int launch(const void* q, const void* c, const float* scale, int Bq, int Bc,
           int D, float* out, void* stream) {
  const dim3 grid((Bc + kTileC - 1) / kTileC, (Bq + kTileQ - 1) / kTileQ);
  l2dist_kernel<TQ, TC><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(c), scale, Bq, Bc, D, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_type / c_type: 0 = f32, 1 = f16, 2 = int8 (c only, with scale).
// Supported pairs: (f32, f32), (f16, f16), (f32, int8). Returns a cudaError_t.
extern "C" int l2dist(const void* q, int q_type, const void* c, int c_type,
                      const float* scale, int Bq, int Bc, int D, float* out,
                      void* stream) {
  if (Bq == 0 || Bc == 0) return 0;
  if (q_type == 0 && c_type == 0 && !scale)
    return launch<float, float>(q, c, scale, Bq, Bc, D, out, stream);
  if (q_type == 1 && c_type == 1 && !scale)
    return launch<__half, __half>(q, c, scale, Bq, Bc, D, out, stream);
  if (q_type == 0 && c_type == 2 && scale)
    return launch<float, int8_t>(q, c, scale, Bq, Bc, D, out, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
