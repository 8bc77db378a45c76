// Grouped matmul for the dropless MoE layer at every width and dtype the
// Pallas kernels take: fp32 or bf16 operands, any K and N. The Hopper kernels
// (gmm.cu) take bf16 with K and N multiples of 64 only; these kernels take
// the rest.
//
// Replaces, for those inputs, the Pallas TPU kernels of
// contrastors_tpu/ops/grouped_matmul.py:
//   gmm_generic  - _gmm_kernel (:75, call :109): out[block] = lhs[block] @
//                  rhs[expert of block], 0 on padding blocks;
//   tgmm_generic - _tgmm_kernel (:125, call :170): drhs[e] = sum over e's
//                  rows of lhs^T dout, 0 for an expert with no rows.
// Both take their output dtype from lhs (the Pallas kernels' :112, :173) and
// accumulate in fp32, as the plain versions in ops/grouped_matmul.py do.
// JAX computes widths that are not multiples of 128 with ragged_dot
// (:243-244); here one kernel covers every width.
//
// What bounds them on an H100: the products. At the MoE layer's widths (K, N
// = 768, 3072) a block of 128 rows does 2*128*K*N FLOP on (128*K + K*N +
// 128*N) elements: hundreds of FLOP per byte, above the balance point of
// either rate. Both run fp32 FMAs (67 TFLOP/s at most); bf16 runs the same
// FMAs on operands widened on load, far from the tensor cores' rate: bf16 is
// here for coverage, and gmm.cu keeps the shapes the main path runs. TF32 on
// the tensor cores keeps only 10 mantissa bits; 3xTF32 (three TF32
// products per fp32 product, as flash_generic.cu's fp32 forward runs them)
// would keep about fp32's precision at 495 / 3 TFLOP/s, 2.5x the FMAs' rate,
// and is not done here yet: torch._grouped_mm, the yardstick, runs full-fp32
// products too.
//
// Both kernels share one register-blocked, pipelined design and its notes
// below: gmm_kernel<T, BM, KN> and tgmm_kernel<T>, 8 x 8 fp32 accumulators
// a thread in 4-wide strips, two shared-memory stages with one barrier a
// 16-deep step. Every output element has one owner and a fixed order of
// sums: no atomics, runs are bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockStep = 64;  // block_m granularity: a gmm block tile's least height

// ---- gmm: register-blocked and pipelined ---------------------------------------
//
// gmm_kernel<T, BM, KN> is the kernel behind gmm_generic, in both dtypes: the
// counterpart of _gmm_kernel (contrastors_tpu/ops/grouped_matmul.py:75, call
// :109) and of the dlhs product of its custom VJP (_gmm_bwd, :206-218: gmm on
// the rhs^T view). tgmm_kernel, further down, reuses its machinery.
//
// What bounds it on an H100: the fp32 FMAs (67 TFLOP/s), at 2*K*N FLOP per
// active row (hundreds of FLOP per byte at the MoE widths). The first design
// reached 21% of that: each thread's 4 x 8 tile read 12 floats from shared
// memory for 32 FMAs, one buffer left the loads and the products in turns,
// operands arrived as scalar loads, and lhs was stored transposed with bank
// conflicts.
//
// What the design does about it (the classic SGEMM shape):
//   - a block of 256 threads owns a BM x 128 output tile, BM = 128 where
//     block_m % 128 == 0 (a tile never spans two experts' blocks), else 64;
//     thread (ty, tx) = (tid / 16, tid % 16) keeps BM / 16 x 8 accumulators in
//     4-wide strips (rows 64 s + 4 ty .., columns 64 s + 4 tx ..), so its
//     float4 reads of a k step fall in distinct banks: 64 FMAs for 16 floats
//     read at BM = 128;
//   - the contraction runs in steps of 16 through two shared-memory stages,
//     one __syncthreads a step: the next step's copies are issued before this
//     step's products and land under them. fp32 operands come by cp.async
//     and no register holds them: 16 bytes a chunk where rows are 16-byte
//     aligned, rhs rows laid out as stored (unit stride over N) straight into
//     the stage, lhs and rhs in the dlhs form (unit stride over K) into a raw
//     buffer as stored, from which each thread moves its own chunks into the
//     stage, transposed, before the step's barrier; at other strides 4 bytes
//     an element, straight into the stage. bf16 operands are widened on load
//     into registers (8-byte loads where aligned, scalar at ragged edges)
//     before the products and written to the other stage after them;
//   - a warp's 16 rows x 2 chunks of 4 along k make the transposed stores
//     conflict-free;
//   - operands are zero past K and N; each output sums k in order with fmaf,
//     the first design's order, so its fp32 outputs are that design's bit
//     for bit. An inactive block writes zeros. Every output element has one
//     owner: no atomics, bit-identical reruns.

constexpr int kGN = 128, kGK = 16;  // columns of a block tile, depth of a k step

template <int BM>
struct GmmSmem {
  float a[2][kGK][BM + 4];  // lhs^T of a k step: a[stage][k][row]
  float b[2][kGK][kGN + 4];  // rhs of a k step: b[stage][k][n]
  float ra[BM][kGK + 4];     // fp32: lhs rows of the next step as stored (16-byte copies)
  float rb[kGN][kGK + 4];    // fp32: the dlhs view's rhs rows of the next step as stored
};

// bf16 p[0], p[es], p[2 es], p[3 es] widened to fp32, zero from element n_ok
// on; one 8-byte load where `vec` (es == 1, aligned) and all four are in
// range. (fp32 operands arrive by cp.async and take no register.)
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, int64_t es, int n_ok, bool vec) {
  if (vec && n_ok >= 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  float x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = i < n_ok ? __bfloat162float(p[i * es]) : 0.f;
  return make_float4(x[0], x[1], x[2], x[3]);
}

// cp.async of `size` (4 or 16) bytes, of which the first `bytes` are read and the rest zero-filled
__device__ __forceinline__ void cp_async(float* dst, const float* src, int size, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (size == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes) : "memory");
}

// R rows x kGK of a k step from rows of stride rs (element stride es along
// k), to be stored transposed: dst[k][row]. Chunk f of the R * 4 (4 along k)
// is row (f % 16) + 16 ((f / 32) % (R / 16)), k 4 ((f / 16) % 2 + 2 (f / 2R))
template <typename T, int R>
struct RowsT {
  float4 v[R / 64];
  static __device__ __forceinline__ int row(int f) { return (f & 15) + 16 * ((f >> 5) % (R / 16)); }
  static __device__ __forceinline__ int kq(int f) { return ((f >> 4) & 1) + 2 * (f / (2 * R)); }
  __device__ __forceinline__ void load(const T* base, int64_t rs, int64_t es, int rows, int k0, int K, bool vec) {
#pragma unroll
    for (int it = 0; it < R / 64; ++it) {
      const int f = threadIdx.x + it * kThreads, r = row(f), k = k0 + 4 * kq(f);
      v[it] = r < rows ? load4(base + r * rs + k * es, es, K - k, vec) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ __forceinline__ void store(float (*dst)[R + 4]) const {
#pragma unroll
    for (int it = 0; it < R / 64; ++it) {
      const int f = threadIdx.x + it * kThreads, r = row(f), k = 4 * kq(f);
      dst[k][r] = v[it].x;
      dst[k + 1][r] = v[it].y;
      dst[k + 2][r] = v[it].z;
      dst[k + 3][r] = v[it].w;
    }
  }
  // fp32, 16-byte aligned rows (rs % 4 == 0): this thread's chunks by 16-byte cp.async into raw[row][k]
  // as stored, zero-filled past rows and K; `unraw` then moves them into dst[k][row]
  static __device__ __forceinline__ void copy_raw(float (*raw)[kGK + 4], const float* base, int64_t rs, int rows,
                                                  int k0, int K) {
#pragma unroll
    for (int it = 0; it < R / 64; ++it) {
      const int f = threadIdx.x + it * kThreads, r = row(f), k = 4 * kq(f);
      const int bytes = r < rows ? 4 * max(0, min(4, K - k0 - k)) : 0;
      cp_async(&raw[r][k], bytes ? base + r * rs + k0 + k : base, 16, bytes);
    }
  }
  static __device__ __forceinline__ void unraw(float (*dst)[R + 4], float (*raw)[kGK + 4]) {
#pragma unroll
    for (int it = 0; it < R / 64; ++it) {
      const int f = threadIdx.x + it * kThreads, r = row(f), k = 4 * kq(f);
      const float4 v = *reinterpret_cast<const float4*>(&raw[r][k]);
      dst[k][r] = v.x;
      dst[k + 1][r] = v.y;
      dst[k + 2][r] = v.z;
      dst[k + 3][r] = v.w;
    }
  }
  // fp32 at any stride: straight into dst[k][row] by 4-byte cp.async, one element each, zero-filled past rows
  // and K
  static __device__ __forceinline__ void copy(float (*dst)[R + 4], const float* base, int64_t rs, int64_t es,
                                              int rows, int k0, int K) {
#pragma unroll
    for (int it = 0; it < R / 64; ++it) {
      const int f = threadIdx.x + it * kThreads, r = row(f), k = 4 * kq(f);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = r < rows && k0 + k + i < K;
        cp_async(&dst[k + i][r], ok ? base + r * rs + (k0 + k + i) * es : base, 4, ok ? 4 : 0);
      }
    }
  }
};

// kGK rows (k) x kGN of rhs with unit stride over N, stored as they are:
// chunk f of the 512 (4 along n) is k f / 32, n 4 (f % 32)
template <typename T>
struct RowsN {
  float4 v[2];
  __device__ __forceinline__ void load(const T* B, int64_t sk, int k0, int K, int n0, int N, bool vec) {
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int f = threadIdx.x + it * kThreads, k = k0 + (f >> 5), n = n0 + 4 * (f & 31);
      v[it] = k < K ? load4(B + k * sk + n, 1, N - n, vec) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ __forceinline__ void store(float (*dst)[kGN + 4]) const {
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int f = threadIdx.x + it * kThreads;
      *reinterpret_cast<float4*>(&dst[f >> 5][4 * (f & 31)]) = v[it];
    }
  }
  // fp32: straight into dst by cp.async, zero-filled past K and N: 16 bytes a chunk where
  // rows are 16-byte aligned (vec), else 4 bytes an element
  static __device__ __forceinline__ void copy(float (*dst)[kGN + 4], const float* B, int64_t sk, int k0, int K,
                                              int n0, int N, bool vec) {
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int f = threadIdx.x + it * kThreads, k = k0 + (f >> 5), n = n0 + 4 * (f & 31);
      float* d = &dst[f >> 5][4 * (f & 31)];
      if (vec) {
        const int bytes = k < K && n < N ? 4 * min(4, N - n) : 0;
        cp_async(d, bytes ? B + k * sk + n : B, 16, bytes);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok = k < K && n + i < N;
          cp_async(d + i, ok ? B + k * sk + n + i : B, 4, ok ? 4 : 0);
        }
      }
    }
  }
};

// acc[i][j] += sum over the k step of a[k][row(i)] * b[k][col(j)],
// row(i) = 64 (i / 4) + 4 ty + i % 4, col(j) = 64 (j / 4) + 4 tx + j % 4
template <int BM>
__device__ __forceinline__ void gmm_step(float (&acc)[BM / 16][8], float (*a)[BM + 4], float (*b)[kGN + 4], int tx,
                                         int ty) {
#pragma unroll
  for (int k = 0; k < kGK; ++k) {
    float x[BM / 16], y[8];
#pragma unroll
    for (int s = 0; s < BM / 64; ++s) {
      const float4 u = *reinterpret_cast<const float4*>(&a[k][64 * s + 4 * ty]);
      x[4 * s] = u.x, x[4 * s + 1] = u.y, x[4 * s + 2] = u.z, x[4 * s + 3] = u.w;
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float4 u = *reinterpret_cast<const float4*>(&b[k][64 * s + 4 * tx]);
      y[4 * s] = u.x, y[4 * s + 1] = u.y, y[4 * s + 2] = u.z, y[4 * s + 3] = u.w;
    }
#pragma unroll
    for (int i = 0; i < BM / 16; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

__device__ __forceinline__ void store4(float* p, const float* x, int n_ok, bool vec) {
  if (vec && n_ok >= 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < n_ok) p[i] = x[i];
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* x, int n_ok, bool vec) {
  if (vec && n_ok >= 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]), hi = __floats2bfloat162_rn(x[2], x[3]);
    *reinterpret_cast<uint2*>(p) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < n_ok) p[i] = __float2bfloat16_rn(x[i]);
}

// KN: rhs has unit stride over N (rows are k); else its rows are n (the dlhs
// view, unit stride over K, or any other strides), transposed on load.
// vec_a / vec_b: lhs / rhs rows allow vector loads (and, for fp32 KN, cp.async)
template <typename T, int BM, bool KN>
__global__ void __launch_bounds__(kThreads, 2) gmm_kernel(const T* lhs, const T* rhs, const int* blk_e,
                                                          const int* act, T* out, int K, int N, int block_m,
                                                          int64_t lda, int64_t se, int64_t sk, int64_t sn, int vec_a,
                                                          int vec_b) {
  extern __shared__ __align__(16) unsigned char gmm_smem[];
  GmmSmem<BM>& sm = *reinterpret_cast<GmmSmem<BM>*>(gmm_smem);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kGN, blk = m0 / block_m;
  float acc[BM / 16][8];
#pragma unroll
  for (int i = 0; i < BM / 16; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int nk = (K + kGK - 1) / kGK;
  if (act[blk] != 0 && nk > 0) {  // uniform over the block
    const T* A = lhs + m0 * lda;
    const T* B = rhs + int64_t(blk_e[blk]) * se;
    if constexpr (sizeof(T) == 4) {
      // fp32: the step at k0 by cp.async, no register holding it: rows to be transposed go to the raw
      // buffers where aligned (each thread moves its own chunks into the stage, `settle`), else element
      // by element straight into stage st; rhs rows as stored straight into stage st
      auto issue = [&](int k0, int st) {
        if (vec_a)
          RowsT<T, BM>::copy_raw(sm.ra, A, lda, BM, k0, K);
        else
          RowsT<T, BM>::copy(sm.a[st], A, lda, 1, BM, k0, K);
        if constexpr (KN) {
          RowsN<T>::copy(sm.b[st], B, sk, k0, K, n0, N, vec_b);
        } else {
          if (vec_b)
            RowsT<T, kGN>::copy_raw(sm.rb, B + n0 * sn, sn, N - n0, k0, K);
          else
            RowsT<T, kGN>::copy(sm.b[st], B + n0 * sn, sn, sk, N - n0, k0, K);
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      };
      auto settle = [&](int st) {
        if (vec_a) RowsT<T, BM>::unraw(sm.a[st], sm.ra);
        if constexpr (!KN) {
          if (vec_b) RowsT<T, kGN>::unraw(sm.b[st], sm.rb);
        }
      };
      issue(0, 0);
      for (int t = 0; t < nk; ++t) {
        const int st = t & 1;
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        settle(st);
        __syncthreads();  // step t is whole in stage st; every thread is done with stage st ^ 1
        if (t + 1 < nk) issue((t + 1) * kGK, st ^ 1);  // raw chunks: this thread's own, already settled
        gmm_step<BM>(acc, sm.a[st], sm.b[st], tx, ty);
      }
    } else {
      // bf16: widened on load into registers before the products, written to the other stage after them
      RowsT<T, BM> la;
      typename std::conditional<KN, RowsN<T>, RowsT<T, kGN>>::type lb;
      auto fetch = [&](int k0) {
        la.load(A, lda, 1, BM, k0, K, vec_a);
        if constexpr (KN)
          lb.load(B, sk, k0, K, n0, N, vec_b);
        else
          lb.load(B + n0 * sn, sn, sk, N - n0, k0, K, vec_b);
      };
      auto place = [&](int st) {
        la.store(sm.a[st]);
        lb.store(sm.b[st]);
      };
      fetch(0);
      place(0);
      __syncthreads();
      for (int t = 0; t < nk; ++t) {
        const int st = t & 1;
        const bool next = t + 1 < nk;
        if (next) fetch((t + 1) * kGK);  // stage st ^ 1 was last read before the previous barrier
        gmm_step<BM>(acc, sm.a[st], sm.b[st], tx, ty);
        if (next) place(st ^ 1);
        __syncthreads();
      }
    }
  }
  const bool vec_out = N % 4 == 0;  // every output row starts on a 4-element boundary
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) {
    T* row = out + int64_t(m0 + 64 * (i >> 2) + 4 * ty + (i & 3)) * N;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int n = n0 + 64 * s + 4 * tx;
      const float x[4] = {acc[i][4 * s], acc[i][4 * s + 1], acc[i][4 * s + 2], acc[i][4 * s + 3]};
      store4(row + n, x, N - n, vec_out);
    }
  }
}

template <typename T, int BM, bool KN>
cudaError_t launch_gmm(dim3 grid, cudaStream_t s, const T* lhs, const T* rhs, const int* be, const int* ac, T* out,
                       int K, int N, int block_m, int64_t lda, int64_t se, int64_t sk, int64_t sn, int vec_a,
                       int vec_b) {
  constexpr int bytes = sizeof(GmmSmem<BM>);  // above the 48 KB of static shared memory: dynamic
  const cudaError_t e = cudaFuncSetAttribute(gmm_kernel<T, BM, KN>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  gmm_kernel<T, BM, KN><<<grid, kThreads, bytes, s>>>(lhs, rhs, be, ac, out, K, N, block_m, lda, se, sk, sn, vec_a,
                                                      vec_b);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_gmm(const T* lhs, const T* rhs, const int* be, const int* ac, T* out, int M, int K, int N,
                    int block_m, int64_t lda, int64_t se, int64_t sk, int64_t sn, cudaStream_t s) {
  constexpr uintptr_t kVec = 4 * sizeof(T);  // bytes of a 4-element vector load
  const int vec_a = reinterpret_cast<uintptr_t>(lhs) % kVec == 0 && lda % 4 == 0;
  const bool kn = sn == 1;
  const int vec_b = reinterpret_cast<uintptr_t>(rhs) % kVec == 0 && se % 4 == 0 &&
                    (kn ? sk % 4 == 0 : sk == 1 && sn % 4 == 0);
  const bool m128 = block_m % 128 == 0;
  const dim3 grid(M / (m128 ? 128 : 64), (N + kGN - 1) / kGN);
  if (m128 && kn)
    return launch_gmm<T, 128, true>(grid, s, lhs, rhs, be, ac, out, K, N, block_m, lda, se, sk, sn, vec_a, vec_b);
  if (m128)
    return launch_gmm<T, 128, false>(grid, s, lhs, rhs, be, ac, out, K, N, block_m, lda, se, sk, sn, vec_a, vec_b);
  if (kn)
    return launch_gmm<T, 64, true>(grid, s, lhs, rhs, be, ac, out, K, N, block_m, lda, se, sk, sn, vec_a, vec_b);
  return launch_gmm<T, 64, false>(grid, s, lhs, rhs, be, ac, out, K, N, block_m, lda, se, sk, sn, vec_a, vec_b);
}

// ---- tgmm: register-blocked and pipelined --------------------------------------
//
// tgmm_kernel<T> is the kernel behind tgmm_generic, in both dtypes: the
// counterpart of _tgmm_kernel (contrastors_tpu/ops/grouped_matmul.py:125,
// call :170): drhs[e] = sum over e's rows r of lhs[r]^T dout[r], zeros for an
// expert with no rows.
//
// What bounds it on an H100: the fp32 FMAs (67 TFLOP/s), at 2*K*N FLOP per
// active row. The first design reached 31% of that: each thread's 4 x 8
// tile read 12 floats from shared memory for 32 FMAs, one buffer left the
// loads and the products in turns, operands arrived as scalar loads into
// 64 x 128 tiles.
//
// What the design does about it (gmm_kernel's machinery):
//   - a block of 256 threads owns a 128 (K) x 128 (N) tile of one expert's
//     drhs, each thread 8 x 8 accumulators in 4-wide strips (`gmm_step`:
//     64 FMAs for 16 floats read);
//   - the contraction runs over the expert's rows, in steps of 16 through two
//     shared-memory stages, one __syncthreads a step: the next step's copies
//     are issued before this step's products and land under them. No
//     transpose: lhs rows [r][k0, k0 + 128) are already a[step row][k] and
//     dout rows b[step row][n], so fp32 operands go straight into the stage
//     by cp.async (`RowsN::copy`), 16 bytes a chunk where rows are 16-byte
//     aligned, else 4 bytes an element, zero-filled past the expert's last
//     row and past K and N; bf16 is widened on load through registers
//     (`RowsN::load`), as in gmm;
//   - blocks take the experts largest first (each block finds its expert's
//     rank from group_sizes; all tiles of an expert together), so that under
//     skewed routing the hot expert's tiles, which walk the most rows, start
//     first instead of setting the tail;
//   - each output sums the expert's rows in order, one fmaf a row, the first
//     design's order: its outputs, in both dtypes, are that design's bit for
//     bit. An expert with no rows writes zeros.

// The expert of rank `rank` when the experts are ordered by row count,
// largest first, ties by index: the one with `rank` experts before it.
__device__ __forceinline__ int expert_of_rank(const int* gs, int E, int rank, int* chosen) {
  for (int e = threadIdx.x; e < E; e += kThreads) {
    const int g = gs[e];
    int before = 0;
    for (int j = 0; j < E; ++j) {
      const int h = gs[j];
      before += h > g || (h == g && j < e);
    }
    if (before == rank) *chosen = e;
  }
  __syncthreads();
  return *chosen;
}

// vec_a / vec_d: lhs / dout rows allow vector loads (and, for fp32, 16-byte cp.async)
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) tgmm_kernel(const T* lhs, const T* dout, const int* gs, T* out, int M,
                                                           int K, int N, int E, int64_t lda, int64_t ldd, int vec_a,
                                                           int vec_d) {
  __shared__ __align__(16) float sa[2][kGK][kGN + 4];  // lhs rows of a step: sa[stage][row][k]
  __shared__ __align__(16) float sb[2][kGK][kGN + 4];  // dout rows of a step: sb[stage][row][n]
  __shared__ int chosen;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n_tiles = (N + kGN - 1) / kGN, tiles = n_tiles * ((K + kGN - 1) / kGN);
  const int e = expert_of_rank(gs, E, blockIdx.x / tiles, &chosen), tile = blockIdx.x % tiles;
  const int k0 = (tile / n_tiles) * kGN, n0 = (tile % n_tiles) * kGN;
  int off = 0;
  for (int i = 0; i < e; ++i) off += gs[i];
  const int end = min(off + gs[e], M);
  const int nk = end > off ? (end - off + kGK - 1) / kGK : 0;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  if constexpr (sizeof(T) == 4) {
    // fp32: the step of rows r0 .. r0 + 15 by cp.async straight into stage st, no register holding it
    auto issue = [&](int r0, int st) {
      RowsN<T>::copy(sa[st], lhs, lda, r0, end, k0, K, vec_a);
      RowsN<T>::copy(sb[st], dout, ldd, r0, end, n0, N, vec_d);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    if (nk > 0) issue(off, 0);
    for (int t = 0; t < nk; ++t) {
      const int st = t & 1;
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();  // step t is whole in stage st; every thread is done with stage st ^ 1
      if (t + 1 < nk) issue(off + (t + 1) * kGK, st ^ 1);
      gmm_step<128>(acc, sa[st], sb[st], tx, ty);
    }
  } else {
    // bf16: widened on load into registers before the products, written to the other stage after them
    RowsN<T> la, lb;
    auto fetch = [&](int r0) {
      la.load(lhs, lda, r0, end, k0, K, vec_a);
      lb.load(dout, ldd, r0, end, n0, N, vec_d);
    };
    auto place = [&](int st) {
      la.store(sa[st]);
      lb.store(sb[st]);
    };
    if (nk > 0) {
      fetch(off);
      place(0);
      __syncthreads();
    }
    for (int t = 0; t < nk; ++t) {
      const int st = t & 1;
      const bool next = t + 1 < nk;
      if (next) fetch(off + (t + 1) * kGK);  // stage st ^ 1 was last read before the previous barrier
      gmm_step<128>(acc, sa[st], sb[st], tx, ty);
      if (next) place(st ^ 1);
      __syncthreads();
    }
  }
  const bool vec_out = N % 4 == 0;  // every output row starts on a 4-element boundary
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + 64 * (i >> 2) + 4 * ty + (i & 3);
    if (k >= K) continue;
    T* row = out + (int64_t(e) * K + k) * N;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int n = n0 + 64 * s + 4 * tx;
      const float x[4] = {acc[i][4 * s], acc[i][4 * s + 1], acc[i][4 * s + 2], acc[i][4 * s + 3]};
      store4(row + n, x, N - n, vec_out);
    }
  }
}

template <typename T>
cudaError_t run_tgmm(const T* lhs, const T* dout, const int* gs, T* out, int M, int K, int N, int E, int64_t lda,
                     int64_t ldd, cudaStream_t s) {
  constexpr uintptr_t kVec = 4 * sizeof(T);  // bytes of a 4-element vector load
  const int vec_a = reinterpret_cast<uintptr_t>(lhs) % kVec == 0 && lda % 4 == 0;
  const int vec_d = reinterpret_cast<uintptr_t>(dout) % kVec == 0 && ldd % 4 == 0;
  const dim3 grid(E * ((K + kGN - 1) / kGN) * ((N + kGN - 1) / kGN));
  tgmm_kernel<T><<<grid, kThreads, 0, s>>>(lhs, dout, gs, out, M, K, N, E, lda, ldd, vec_a, vec_d);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 fp32, 1 bf16 (lhs, rhs and out alike). lhs [M, K] (row stride lda,
// unit stride over K), rhs [E, K, N] with strides (se, sk, sn), blk_e / act
// int32 [M / block_m]; out contiguous [M, N]. block_m a multiple of 64 and
// M a multiple of block_m.
extern "C" int gmm_generic(int dtype, const void* lhs, const void* rhs, const void* blk_e, const void* act, void* out,
                           int M, int K, int N, int E, int block_m, int64_t lda, int64_t se, int64_t sk, int64_t sn,
                           void* stream) {
  if ((dtype != 0 && dtype != 1) || block_m <= 0 || block_m % kBlockStep || M % block_m || K < 0 || N < 0 || E <= 0)
    return int(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return int(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* be = static_cast<const int*>(blk_e);
  const int* ac = static_cast<const int*>(act);
  if (dtype == 0)
    return int(run_gmm(static_cast<const float*>(lhs), static_cast<const float*>(rhs), be, ac,
                       static_cast<float*>(out), M, K, N, block_m, lda, se, sk, sn, s));
  return int(run_gmm(static_cast<const __nv_bfloat16*>(lhs), static_cast<const __nv_bfloat16*>(rhs), be, ac,
                     static_cast<__nv_bfloat16*>(out), M, K, N, block_m, lda, se, sk, sn, s));
}

// lhs [M, K], dout [M, N] (row strides lda, ldd, unit strides over K, N),
// group_sizes int32 [E] (aligned, summing to at most M); out contiguous
// [E, K, N], zeros for an expert with no rows.
extern "C" int tgmm_generic(int dtype, const void* lhs, const void* dout, const void* group_sizes, void* out, int M,
                            int K, int N, int E, int64_t lda, int64_t ldd, void* stream) {
  if ((dtype != 0 && dtype != 1) || M < 0 || K < 0 || N < 0 || E < 0) return int(cudaErrorInvalidValue);
  if (E == 0 || K == 0 || N == 0) return int(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gs = static_cast<const int*>(group_sizes);
  if (dtype == 0)
    return int(run_tgmm(static_cast<const float*>(lhs), static_cast<const float*>(dout), gs, static_cast<float*>(out),
                        M, K, N, E, lda, ldd, s));
  return int(run_tgmm(static_cast<const __nv_bfloat16*>(lhs), static_cast<const __nv_bfloat16*>(dout), gs,
                      static_cast<__nv_bfloat16*>(out), M, K, N, E, lda, ldd, s));
}
