// Squared-L2 distance matrix on Hopper's tensor cores, f32-accurate.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   * l2dist_pallas (repro/kernels/l2dist.py:72, body _l2dist_kernel):
//     q [Bq, D] x c [Bc, D], f32 or f16, -> [Bq, Bc] f32;
//   * int8_l2dist_pallas (repro/kernels/int8dist.py:72, body _int8_kernel):
//     the same against int8 rows c_q with one f32 scale per row.
// out[i, j] = |q_i|^2 - 2 * dot(q_i, c_j) + |c_j|^2, in the reference's order
// of the three terms.
//
// What bounds it on the H100: tensor-core operations. The products run as
// TF32 wgmma in as many passes as the input types need for f32 accuracy:
//   * f32 x f32, 3 passes. Each value is split into hi = tf32(x) (round to
//     nearest, ties away, as cvt.rna.tf32.f32) and lo = x - hi (exact in
//     f32; the tensor core reads its top 19 bits), and
//     q.c ~ lo_q.hi_c + hi_q.lo_c + hi_q.hi_c (lo.lo dropped, the two small
//     products first). Each dropped or truncated term is below 2^-20 of its
//     product, so the products are as accurate as f32 math; one TF32 pass is
//     5 to 70 times the tolerance below (tests/test_torch_l2dist_split.py).
//   * f32 x int8, 2 passes: every int8 value is exact in TF32, so
//     q.c_q ~ lo_q.c_q + hi_q.c_q; the row's scale is applied once to the
//     sum, out = |q|^2 - 2 * (s_j * acc) + |c_j|^2, where the reference
//     dequantizes before the product (equal in exact arithmetic).
//   * f16 x f16, 1 pass: f16 values are exact in TF32.
// The tensor core truncates as it accumulates, so each depth tile of 32 is
// summed from zero and added to the running f32 sum on the CUDA cores; summed
// over all 768 of D in the tensor core, the error reached the tolerance.
// The bound is passes * 2*Bq*Bc*D operations at the dense TF32 rate
// (495 TFLOP/s); the bytes (each input once, the output once) are far below.
// The norms are summed in f32 on the CUDA cores from the staged tiles (int8
// rows dequantized, c_q * s, as the reference), so one launch does all.
//
// Tiling: a block of two warpgroups computes a 128 x 128 output tile, each
// warpgroup 64 x 128 with wgmma m64n128k8: A (q, split into hi and lo) from
// registers, B (c) from shared memory. The depth runs in tiles of 32 through
// a ring of 4 slots of raw rows, filled by TMA from one thread (two boxes of
// 128 rows x 32 a tile, zero-filled past Bq, Bc and D; f32 rows in the
// 128-byte swizzle) and waited on with an mbarrier per slot. While the tensor
// cores work on depth tile k, every thread converts one half row of tile
// k+1's c into TF32 planes (hi, and lo for f32 rows; int8 and f16 rows
// widened to f32) in the 128-byte-swizzled K-major layout that wgmma reads,
// double-buffered, and sums its norm; one barrier per depth tile. The planes
// hold k in a permuted order, so that A fragments load as 16-byte vectors.
// Rows whose D or base pointer rule out TMA (D % 4 for f32, % 8 for f16,
// % 16 for int8, 16-byte-aligned bases) go through a second instantiation of
// the same kernel that stages with plain loads. The output is stored as
// float2 from the accumulator layout, masked at the edges.
#include <cuda.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTileQ = 128, kTileC = 128, kDepth = 32, kThreads = 256, kStages = 4;
constexpr int kPlane = kTileC * kDepth * 4;   // one TF32 plane of a c tile: 16 KB

// Bytes of one staged row of kDepth raw elements.
template <typename T> __host__ __device__ constexpr int row_bytes() {
  return kDepth * static_cast<int>(sizeof(T));
}
template <typename TQ, typename TC> __host__ __device__ constexpr int stage_bytes() {
  return kTileQ * row_bytes<TQ>() + kTileC * row_bytes<TC>();
}
template <typename TC> __host__ __device__ constexpr int planes() {   // per buffer
  return std::is_same<TC, float>::value ? 2 : 1;
}
template <typename TQ, typename TC> __host__ __device__ constexpr int smem_bytes() {
  return 1024 + 2 * planes<TC>() * kPlane + kStages * stage_bytes<TQ, TC>();  // 1024: alignment
}
// Byte offset of byte b of staged row r. f32 rows (128 bytes) are staged
// with their 16-byte chunks XOR-swizzled by r % 8 (the tensor map's 128-byte
// swizzle), so the 16-byte loads of a quarter warp (two rows, the same chunks)
// fall in different banks.
template <typename T> __device__ __forceinline__ int raw_off(int r, int b) {
  if constexpr (sizeof(T) == 4) return r * 128 + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
  return r * row_bytes<T>() + b;
}

__device__ __forceinline__ uint32_t tf32_hi(float x) {       // cvt.rna.tf32.f32
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(b)), "r"(count));
}
__device__ __forceinline__ bool mbar_try(uint32_t a, int parity) {
  uint32_t done;
  asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
               "selp.u32 %0, 1, 0, p;\n}\n"
               : "=r"(done) : "r"(a), "r"(parity) : "memory");
  return done;
}
// Waits for the phase of parity `parity` to complete. A wait of about ten
// seconds means a lost copy: the kernel traps rather than hangs the card.
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  const uint32_t a = smem_u32(b);
  if (mbar_try(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(a, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}
// TMA: the [128 rows, kDepth] box of the tensor map at (k0, row0) into smem;
// its bytes count against the barrier's expected transaction (rows and depth
// past the tensor arrive as zeros).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int k0, int row0,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(row0),
         "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* b, int bytes) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n"
               :: "r"(smem_u32(b)), "r"(bytes) : "memory");
}

// Shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (the leading offset is unused in this layout).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d[64] (+)= a . B: one m64n128k8 TF32 product of the warpgroup; a is this
// lane's A fragment (rows g, g+8 of its warp's 16, k slots t and t+4).
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accesses of d across the asynchronous product.
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Generic-proxy accesses of shared memory, ordered with wgmma's and TMA's.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Four int8 values of a word -> f32, exact: the byte b + 128 under the
// exponent of 2^23, minus 2^23 + 128.
__device__ __forceinline__ void s8x4(uint32_t w, float (&v)[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | i)) - 8388736.f;
}

// The four values k = 4m..4m+3 of staged row r of a raw tile, as f32.
__device__ __forceinline__ void chunk4(const float*, const unsigned char* tile, int r, int m,
                                       float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(tile + raw_off<float>(r, 16 * m));
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void chunk4(const __half*, const unsigned char* tile, int r, int m,
                                       float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(tile + raw_off<__half>(r, 8 * m));
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&x.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&x.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void chunk4(const int8_t*, const unsigned char* tile, int r, int m,
                                       float (&v)[4]) {
  s8x4(*reinterpret_cast<const uint32_t*>(tile + raw_off<int8_t>(r, 4 * m)), v);
}
// Lane t's 8 values k = 8t..8t+7 of staged q row r.
__device__ __forceinline__ void load8(const float*, const unsigned char* tile, int r, int t,
                                      float (&v)[8]) {
  const float4 x = *reinterpret_cast<const float4*>(tile + raw_off<float>(r, 32 * t));
  const float4 y = *reinterpret_cast<const float4*>(tile + raw_off<float>(r, 32 * t + 16));
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w; v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
}
__device__ __forceinline__ void load8(const __half*, const unsigned char* tile, int r, int t,
                                      float (&v)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(tile + raw_off<__half>(r, 16 * t));
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
    v[2 * i] = f.x; v[2 * i + 1] = f.y;
  }
}

// Stage rows [row0, row0 + 128) x depth [k0, k0 + 32) of src [B, D] with plain
// loads, zeros past B and D: the path for rows that TMA cannot copy.
template <typename T>
__device__ __forceinline__ void stage_rows(unsigned char* smem, const T* __restrict__ src,
                                           int row0, int B, int k0, int D, int tid) {
#pragma unroll 4
  for (int it = 0; it < kTileQ * kDepth / kThreads; ++it) {
    const int e = tid + it * kThreads, r = e / kDepth, kk = e % kDepth;
    const int gr = row0 + r, gk = k0 + kk;
    *reinterpret_cast<T*>(smem + raw_off<T>(r, kk * static_cast<int>(sizeof(T)))) =
        (gr < B && gk < D) ? src[static_cast<size_t>(gr) * D + gk] : T();
  }
}

// The k order of the TF32 planes: within a depth tile, slot p = 8s + 4j + t of
// k-step s holds k = 8t + 2s + j (A and B alike, so the products are
// unchanged). Lane t of a quad then holds k = 8t..8t+7 of its A rows: two
// 16-byte loads a row, not eight 4-byte ones.
//
// One thread's share of a c tile's conversion: half h of row r, the values
// k = 8t + 4h + e (t, e = 0..3), into the planes' chunks 4h + e (position t)
// at `hi` (and `hi + kPlane` for lo), adding the squares of the
// (dequantized, times s) values to `norm`.
template <typename TC>
__device__ __forceinline__ void convert_c(const unsigned char* raw, unsigned char* hi,
                                          float s, int tid, float& norm) {
  const int r = tid >> 1, h = tid & 1;
  float v[4][4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    chunk4(static_cast<const TC*>(nullptr), raw, r, 2 * t + h, v[t]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float d = std::is_same<TC, int8_t>::value ? __fmul_rn(v[t][e], s) : v[t][e];
      norm = fmaf(d, d, norm);
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int off = r * 128 + (((4 * h + e) ^ (r & 7)) << 4);   // the 128-byte swizzle
    if constexpr (std::is_same<TC, float>::value) {
      uint32_t hh[4], l[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        hh[t] = tf32_hi(v[t][e]);
        l[t] = __float_as_uint(v[t][e] - __uint_as_float(hh[t]));
      }
      *reinterpret_cast<uint4*>(hi + off) = make_uint4(hh[0], hh[1], hh[2], hh[3]);
      *reinterpret_cast<uint4*>(hi + kPlane + off) = make_uint4(l[0], l[1], l[2], l[3]);
    } else {
      *reinterpret_cast<float4*>(hi + off) = make_float4(v[0][e], v[1][e], v[2][e], v[3][e]);
    }
  }
}

// kTma: the raw tiles come by TMA (16-byte-aligned rows); else by plain loads.
template <typename TQ, typename TC, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
    l2dist_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap cmap, const TQ* __restrict__ q,
                  const TC* __restrict__ c, const float* __restrict__ scale, int Bq, int Bc,
                  int D, float* __restrict__ out) {
  constexpr bool kSplitQ = std::is_same<TQ, float>::value;  // f32 queries: hi + lo
  constexpr bool kSplitC = std::is_same<TC, float>::value;  // f32 rows: hi + lo
  constexpr int QB = kTileQ * row_bytes<TQ>(), SB = stage_bytes<TQ, TC>();
  constexpr int S = kStages, PB = planes<TC>() * kPlane;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float qn_s[kTileQ], cn_s[kTileC];
  __shared__ __align__(8) uint64_t full[S];               // a ring slot's tile landed
  unsigned char* plane = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = plane + 2 * PB;                   // 2 plane buffers, then S slots

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ra = 64 * (warp >> 2) + 16 * (warp & 3) + g;   // this lane's rows ra, ra + 8
  const int row0 = blockIdx.x * kTileQ, col0 = blockIdx.y * kTileC;
  const int KT = (D + kDepth - 1) / kDepth;
  const int cr = tid >> 1;                                 // the c row this thread converts
  const float cs = (scale && col0 + cr < Bc) ? scale[col0 + cr] : 1.f;
  float qna = 0.f, qnb = 0.f, cnorm = 0.f;
  if (kTma && tid == 0) {
    for (int i = 0; i < S; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;

  auto stage = [&](int kt) {       // tile kt into its ring slot
    if (kt >= KT) return;
    unsigned char* base = ring + (kt % S) * SB;
    if constexpr (kTma) {
      if (tid == 0) {
        fence_proxy_async();       // the slot's last generic reads, before the copy
        mbar_expect(&full[kt % S], SB);
        tma_load(base, &qmap, kt * kDepth, row0, &full[kt % S]);
        tma_load(base + QB, &cmap, kt * kDepth, col0, &full[kt % S]);
      }
    } else {
      stage_rows<TQ>(base, q, row0, Bq, kt * kDepth, D, tid);
      stage_rows<TC>(base + QB, c, col0, Bc, kt * kDepth, D, tid);
    }
  };
  auto landed = [&](int kt) {
    if constexpr (kTma) mbar_wait(&full[kt % S], (kt / S) & 1);
  };
  auto convert = [&](int kt) {
    landed(kt);
    convert_c<TC>(ring + (kt % S) * SB + QB, plane + (kt & 1) * PB, cs, tid, cnorm);
    fence_proxy_async();
  };
  for (int s = 0; s < S - 1; ++s) stage(s);
  __syncthreads();                                         // plain loads: tile 0 staged
  if (KT > 0) convert(0);

  for (int kt = 0; kt < KT; ++kt) {
    __syncthreads();   // tile kt converted, tile kt-1's products done, its slot free
    stage(kt + S - 1);

    // A fragments of the 4 k-steps: slots t and t + 4 of k-step s are
    // k = 8t + 2s and 8t + 2s + 1 of rows ra, ra + 8
    landed(kt);
    const unsigned char* qt = ring + (kt % S) * SB;
    float va[8], vb[8];
    load8(static_cast<const TQ*>(nullptr), qt, ra, t, va);
    load8(static_cast<const TQ*>(nullptr), qt, ra + 8, t, vb);
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float a[4] = {va[2 * s], vb[2 * s], va[2 * s + 1], vb[2 * s + 1]};
      qna = fmaf(a[2], a[2], fmaf(a[0], a[0], qna));
      qnb = fmaf(a[3], a[3], fmaf(a[1], a[1], qnb));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kSplitQ) {
          ah[s][e] = tf32_hi(a[e]);
          al[s][e] = __float_as_uint(a[e] - __uint_as_float(ah[s][e]));
        } else {
          ah[s][e] = __float_as_uint(a[e]);               // exact in TF32
        }
      }
    }

    // this depth tile's products, from zero (the first product overwrites)
    const unsigned char* bh = plane + (kt & 1) * PB;
    wgmma_fence();
    fence_operands(part);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint64_t dh = sw128_desc(bh + 32 * s);
      if constexpr (kSplitC) {
        wgmma_tf32(part, al[s], dh, s > 0);
        wgmma_tf32(part, ah[s], sw128_desc(bh + kPlane + 32 * s), 1);
      } else if constexpr (kSplitQ) {
        wgmma_tf32(part, al[s], dh, s > 0);
      }
      wgmma_tf32(part, ah[s], dh, (kSplitQ || s > 0) ? 1 : 0);
    }
    wgmma_commit();
    if (kt + 1 < KT) convert(kt + 1);   // on the CUDA cores, beside the products
    wgmma_wait();
    fence_operands(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
  }

  // norms: q rows over the quad's four lanes, c rows over the thread pair
  qna += __shfl_xor_sync(0xffffffffu, qna, 1);
  qna += __shfl_xor_sync(0xffffffffu, qna, 2);
  qnb += __shfl_xor_sync(0xffffffffu, qnb, 1);
  qnb += __shfl_xor_sync(0xffffffffu, qnb, 2);
  cnorm += __shfl_xor_sync(0xffffffffu, cnorm, 1);
  if (t == 0) { qn_s[ra] = qna; qn_s[ra + 8] = qnb; }
  if ((tid & 1) == 0) cn_s[cr] = cnorm;
  __syncthreads();

  const bool vec = (Bc & 1) == 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int lc = 8 * j + 2 * t, gc = col0 + lc;
    if (gc >= Bc) continue;
    const bool two = gc + 1 < Bc;
    const float s0 = scale ? scale[gc] : 1.f;
    const float s1 = (scale && two) ? scale[gc + 1] : 1.f;
    const float cn0 = cn_s[lc], cn1 = cn_s[lc + 1];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rl = ra + 8 * half, gr = row0 + rl;
      if (gr >= Bq) continue;
      float d0 = acc[4 * j + 2 * half], d1 = acc[4 * j + 2 * half + 1];
      if (scale) { d0 = __fmul_rn(s0, d0); d1 = __fmul_rn(s1, d1); }
      const float qn = qn_s[rl];
      const float o0 = __fadd_rn(__fsub_rn(qn, __fmul_rn(2.f, d0)), cn0);
      const float o1 = __fadd_rn(__fsub_rn(qn, __fmul_rn(2.f, d1)), cn1);
      float* dst = out + static_cast<size_t>(gr) * Bc + gc;
      if (vec && two) {
        *reinterpret_cast<float2*>(dst) = make_float2(o0, o1);
      } else {
        dst[0] = o0;
        if (two) dst[1] = o1;
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up once through the runtime's entry-point
// query, so that nothing links against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [rows, D] tensor, boxes of [128 rows, kDepth]: f32 with the 128-byte
// swizzle that raw_off and the fragment loads assume, f16 and int8 plain.
template <typename T>
bool tensor_map(CUtensorMap* map, const void* p, int rows, int D) {
  const auto encode = encoder();
  if (!encode) return false;
  const CUtensorMapDataType type = sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                    : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * sizeof(T)};
  const cuuint32_t box[2] = {kDepth, kTileQ}, step[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(p), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                sizeof(T) == 4 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TQ, typename TC, bool kTma>
int launch_one(const CUtensorMap& qmap, const CUtensorMap& cmap, const void* q, const void* c,
               const float* scale, int Bq, int Bc, int D, float* out, cudaStream_t stream) {
  constexpr int smem = smem_bytes<TQ, TC>();
  auto kernel = l2dist_kernel<TQ, TC, kTma>;
  static bool sized = false;     // the attribute is per kernel; setting it twice is harmless
  if (!sized) {
    const cudaError_t rc =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    sized = true;
  }
  const dim3 grid((Bq + kTileQ - 1) / kTileQ, (Bc + kTileC - 1) / kTileC);
  kernel<<<grid, kThreads, smem, stream>>>(qmap, cmap, static_cast<const TQ*>(q),
                                           static_cast<const TC*>(c), scale, Bq, Bc, D, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TC>
int launch(const void* q, const void* c, const float* scale, int Bq, int Bc, int D,
           float* out, void* stream) {
  if ((Bc + kTileC - 1) / kTileC > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [D](const void* p, int elt) {
    return (reinterpret_cast<uintptr_t>(p) % 16 == 0) && (static_cast<long>(D) * elt % 16 == 0);
  };
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap qmap{}, cmap{};
  if (aligned(q, sizeof(TQ)) && aligned(c, sizeof(TC))) {
    if (!tensor_map<TQ>(&qmap, q, Bq, D) || !tensor_map<TC>(&cmap, c, Bc, D))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_one<TQ, TC, true>(qmap, cmap, q, c, scale, Bq, Bc, D, out, s);
  }
  return launch_one<TQ, TC, false>(qmap, cmap, q, c, scale, Bq, Bc, D, out, s);
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
