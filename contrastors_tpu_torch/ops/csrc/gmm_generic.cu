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
// What bounds it on an H100: the products. At the MoE layer's widths (K, N
// = 768, 3072) a block of 128 rows does 2*128*K*N FLOP on (128*K + K*N +
// 128*N) elements: hundreds of FLOP per byte, above the balance point of
// either rate. fp32 has no tensor-core rate that keeps fp32 precision, so
// the products are fp32 FMAs (67 TFLOP/s at most); bf16 runs the same FMAs
// on operands widened on load, far from the tensor cores' rate: these
// kernels are for coverage, and gmm.cu keeps the shapes the main path runs.
//
// Design: the classic register-blocked product. A block of 256 threads owns
// a 64 x 128 output tile (gmm: 64 rows of one expert's block, so block_m
// must be a multiple of 64; tgmm: 64 of K by 128 of N of one expert) and
// walks the contraction in steps of 16 through shared memory, operands
// widened to fp32 and zero past the edges; each thread keeps a 4 x 8 tile of
// accumulators (rows ty*4 .. +3, columns tx*4 .. +3 and 64 + tx*4 .. +3) and
// reads its operands as float4. rhs is read through its strides (unit over N,
// or over K for the backward's rhs^T view). Every output element has one
// owner and a fixed order of sums: no atomics, runs are bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256, kTM = 64, kTN = 128, kTK = 16;
constexpr int kPadM = kTM + 4, kPadN = kTN + 4;  // row strides that keep float4 alignment

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
};
template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
};

// acc[i][j] += sum_k As[k][ty*4 + i] * Bs[k][col(j)], col(j) = tx*4 + (j & 3) + 64 * (j >> 2)
__device__ __forceinline__ void tile_fma(float (&acc)[4][8], float (*As)[kPadM], float (*Bs)[kPadN],
                                         int tx, int ty) {
#pragma unroll
  for (int k = 0; k < kTK; ++k) {
    const float4 x = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
    const float4 y0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
    const float4 y1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
    const float xs[4] = {x.x, x.y, x.z, x.w};
    const float ys[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xs[i], ys[j], acc[i][j]);
  }
}

template <typename T>
__device__ __forceinline__ void store_tile(T* out, int64_t ld, const float (&acc)[4][8], int r0, int n_rows, int n0,
                                           int N, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx * 4 + (j & 3) + 64 * (j >> 2);
      if (n < N) Elem<T>::store(out + r * ld + n, acc[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) gmm_kernel(const T* lhs, const T* rhs, const int* blk_e, const int* act,
                                                       T* out, int K, int N, int block_m, int64_t lda, int64_t se,
                                                       int64_t sk, int64_t sn) {
  __shared__ __align__(16) float As[kTK][kPadM];  // As[k][row]
  __shared__ __align__(16) float Bs[kTK][kPadN];  // Bs[k][n]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * kTM, n0 = blockIdx.y * kTN, blk = m0 / block_m;
  float acc[4][8] = {};
  if (act[blk] != 0) {  // uniform over the block
    const T* B = rhs + int64_t(blk_e[blk]) * se;
    for (int k0 = 0; k0 < K; k0 += kTK) {
      for (int idx = tid; idx < kTM * kTK; idx += kThreads) {
        const int r = idx / kTK, kk = idx % kTK, k = k0 + kk;
        As[kk][r] = k < K ? Elem<T>::load(lhs + (m0 + r) * lda + k) : 0.f;
      }
      for (int idx = tid; idx < kTK * kTN; idx += kThreads) {
        const int kk = sn == 1 ? idx / kTN : idx % kTK, j = sn == 1 ? idx % kTN : idx / kTK;
        const int k = k0 + kk, n = n0 + j;
        Bs[kk][j] = k < K && n < N ? Elem<T>::load(B + k * sk + n * sn) : 0.f;
      }
      __syncthreads();
      tile_fma(acc, As, Bs, tx, ty);
      __syncthreads();
    }
  }
  store_tile<T>(out, N, acc, m0, m0 + kTM, n0, N, tx, ty);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) tgmm_kernel(const T* lhs, const T* dout, const int* gs, T* out, int M,
                                                        int K, int N, int64_t lda, int64_t ldd) {
  __shared__ __align__(16) float As[kTK][kPadM];  // As[row][k]
  __shared__ __align__(16) float Bs[kTK][kPadN];  // Bs[row][n]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * kTN, k0 = blockIdx.y * kTM, e = blockIdx.z;
  int off = 0;
  for (int i = 0; i < e; ++i) off += gs[i];
  const int end = min(off + gs[e], M);
  float acc[4][8] = {};
  for (int r0 = off; r0 < end; r0 += kTK) {
    for (int idx = tid; idx < kTK * kTM; idx += kThreads) {
      const int rr = idx / kTM, kk = idx % kTM, r = r0 + rr, k = k0 + kk;
      As[rr][kk] = r < end && k < K ? Elem<T>::load(lhs + r * lda + k) : 0.f;
    }
    for (int idx = tid; idx < kTK * kTN; idx += kThreads) {
      const int rr = idx / kTN, j = idx % kTN, r = r0 + rr, n = n0 + j;
      Bs[rr][j] = r < end && n < N ? Elem<T>::load(dout + r * ldd + n) : 0.f;
    }
    __syncthreads();
    tile_fma(acc, As, Bs, tx, ty);
    __syncthreads();
  }
  store_tile<T>(out + int64_t(e) * K * N, N, acc, k0, K, n0, N, tx, ty);
}

}  // namespace

// dtype: 0 fp32, 1 bf16 (lhs, rhs and out alike). lhs [M, K] (row stride lda,
// unit stride over K), rhs [E, K, N] with strides (se, sk, sn), blk_e / act
// int32 [M / block_m]; out contiguous [M, N]. block_m a multiple of 64 and
// M a multiple of block_m.
extern "C" int gmm_generic(int dtype, const void* lhs, const void* rhs, const void* blk_e, const void* act, void* out,
                           int M, int K, int N, int E, int block_m, int64_t lda, int64_t se, int64_t sk, int64_t sn,
                           void* stream) {
  if ((dtype != 0 && dtype != 1) || block_m <= 0 || block_m % kTM || M % block_m || K < 0 || N < 0 || E <= 0)
    return int(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return int(cudaSuccess);
  const dim3 grid(M / kTM, (N + kTN - 1) / kTN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* be = static_cast<const int*>(blk_e);
  const int* ac = static_cast<const int*>(act);
  if (dtype == 0)
    gmm_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(lhs), static_cast<const float*>(rhs), be,
                                                ac, static_cast<float*>(out), K, N, block_m, lda, se, sk, sn);
  else
    gmm_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(lhs), static_cast<const __nv_bfloat16*>(rhs), be, ac,
        static_cast<__nv_bfloat16*>(out), K, N, block_m, lda, se, sk, sn);
  return int(cudaGetLastError());
}

// lhs [M, K], dout [M, N] (row strides lda, ldd, unit strides over K, N),
// group_sizes int32 [E] (aligned, summing to at most M); out contiguous
// [E, K, N], zeros for an expert with no rows.
extern "C" int tgmm_generic(int dtype, const void* lhs, const void* dout, const void* group_sizes, void* out, int M,
                            int K, int N, int E, int64_t lda, int64_t ldd, void* stream) {
  if ((dtype != 0 && dtype != 1) || M < 0 || K < 0 || N < 0 || E < 0) return int(cudaErrorInvalidValue);
  if (E == 0 || K == 0 || N == 0) return int(cudaSuccess);
  const dim3 grid((N + kTN - 1) / kTN, (K + kTM - 1) / kTM, E);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gs = static_cast<const int*>(group_sizes);
  if (dtype == 0)
    tgmm_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(lhs), static_cast<const float*>(dout), gs,
                                                 static_cast<float*>(out), M, K, N, lda, ldd);
  else
    tgmm_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(lhs), static_cast<const __nv_bfloat16*>(dout), gs,
        static_cast<__nv_bfloat16*>(out), M, K, N, lda, ldd);
  return int(cudaGetLastError());
}
