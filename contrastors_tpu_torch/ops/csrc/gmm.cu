// Grouped matmul and its transpose for Hopper (sm_90a): bf16 operands,
// fp32 accumulation, bf16 results. The compute of the dropless MoE layer.
//
// Replaces the two Pallas TPU kernels of contrastors_tpu/ops/grouped_matmul.py:
//   _gmm_kernel  (:75, call _gmm_call :92)   -> gmm_kernel,
//   _tgmm_kernel (:125, call _tgmm_call :156) -> tgmm_kernel.
// Rows are laid out by expert with every group start aligned to 128 rows
// (block_m), so each 128-row block of lhs belongs to one expert:
//   gmm:  out[block i] = lhs[block i] @ rhs[blk_e[i]], and 0 where act[i] == 0
//         (blocks past the last group are padding);
//   tgmm: out[e] = sum over e's blocks of lhs_b^T @ dout_b, 0 for an expert
//         with no rows.
// The Pallas gmm walks a (N tile, M block) grid with M innermost so that an
// expert's rhs panel stays resident in VMEM while its blocks pass. Here a
// block of 256 threads owns one (128-row block, 128-column tile) and the grid
// runs the M blocks fastest (blockIdx.x), so the blocks in flight together
// read one expert's panel from L2. The Pallas tgmm carries its accumulator in
// VMEM across the sequential M axis and flushes it at expert boundaries; here
// a block owns one (expert, 128 K rows, 128 N columns) output tile and loops
// over that expert's rows itself, with the sum in fp32 registers: one owner
// per output tile, no atomics, deterministic.
//
// What bounds them on an H100: gmm does 2*K*N FLOP per active row against
// lhs, the E rhs panels and out moved once; at the MoE layer's shapes
// (K, N = 768, 3072 and 3072, 768, thousands of rows) that is ~1000 FLOP per
// byte, well above the card's ~295 FLOP/byte balance for bf16, so tensor-core
// operations bound both kernels. The design runs every product on bf16 tensor
// cores (mma.sync m16n8k16, fp32 accumulation), stages 64-deep slices of both
// operands through shared memory with 16-byte loads and a padded row stride
// (no bank conflicts on fragment reads), and skips inactive blocks. It is the
// simple first design: synchronous staging, no wgmma, TMA, cp.async
// pipelining or persistent scheduling, so it is expected to stay well short
// of the bound.
//
// rhs of gmm is taken through its strides: either unit stride over N (the
// forward's [E, K, N] weights) or unit stride over K (the backward's
// rhs.transpose(1, 2) view for dlhs), each staged in its own layout.

#include "flash_common.cuh"

namespace {

using flash::ld32;
using flash::mma_16816;
using flash::pack_bf16;

constexpr int kBlockM = 128;  // rows of one expert block (block_m)
constexpr int kTileN = 128;   // output columns of a gmm block; K and N rows of a tgmm block
constexpr int kDepth = 64;    // contraction depth staged per step
constexpr int kThreads = 256;  // 8 warps: 4 along rows x 2 along columns, 32 x 64 each
constexpr int kStrideDepth = kDepth + 8;  // padded stride of a tile stored depth-contiguous
constexpr int kStrideTile = kTileN + 8;   // padded stride of a tile stored column-contiguous

struct GmmParams {
  const __nv_bfloat16* lhs;  // [M, K], row stride lhs_sm, unit stride over K
  const __nv_bfloat16* rhs;  // [E, K, N], strides rhs_se, rhs_sk, rhs_sn
  const int* blk_e;          // [M / 128] expert of each block
  const int* act;            // [M / 128] 1 = active, 0 = padding block
  __nv_bfloat16* out;        // [M, N] contiguous
  int M, K, N;
  int64_t lhs_sm, rhs_se, rhs_sk, rhs_sn;
};

// One (128-row block, 128-column tile) of out. kRhsNContig: rhs has unit
// stride over N and is staged [depth][n]; otherwise unit stride over K,
// staged [n][depth].
template <bool kRhsNContig>
__global__ void __launch_bounds__(kThreads) gmm_kernel(const GmmParams p) {
  __shared__ __align__(16) __nv_bfloat16 a_s[kBlockM * kStrideDepth];
  constexpr int kBElems = kRhsNContig ? kDepth * kStrideTile : kTileN * kStrideDepth;
  __shared__ __align__(16) __nv_bfloat16 b_s[kBElems];

  const int blk = blockIdx.x, n0 = blockIdx.y * kTileN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 64;  // this warp's rows and columns
  __nv_bfloat16* out = p.out + int64_t(blk) * kBlockM * p.N;

  if (p.act[blk] == 0) {  // a padding block: zero-fill, no product
    for (int i = tid; i < kBlockM * (kTileN / 8); i += kThreads) {
      const int r = i / (kTileN / 8), c = n0 + (i % (kTileN / 8)) * 8;
      if (c < p.N) *reinterpret_cast<uint4*>(out + int64_t(r) * p.N + c) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  const __nv_bfloat16* lhs = p.lhs + int64_t(blk) * kBlockM * p.lhs_sm;
  const __nv_bfloat16* rhs = p.rhs + int64_t(p.blk_e[blk]) * p.rhs_se;

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += kDepth) {
    // lhs rows [0, 128) x depth [k0, k0 + 64), stored [row][depth]
    for (int i = tid; i < kBlockM * (kDepth / 8); i += kThreads) {
      const int r = i / (kDepth / 8), ch = i % (kDepth / 8);
      *reinterpret_cast<uint4*>(a_s + r * kStrideDepth + ch * 8) =
          *reinterpret_cast<const uint4*>(lhs + r * p.lhs_sm + k0 + ch * 8);
    }
    if constexpr (kRhsNContig) {  // rhs[e] rows k0.. x columns n0.., stored [depth][n]
      for (int i = tid; i < kDepth * (kTileN / 8); i += kThreads) {
        const int kk = i / (kTileN / 8), ch = i % (kTileN / 8), n = n0 + ch * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (n < p.N) v = *reinterpret_cast<const uint4*>(rhs + (k0 + kk) * p.rhs_sk + n);
        *reinterpret_cast<uint4*>(b_s + kk * kStrideTile + ch * 8) = v;
      }
    } else {  // unit stride over K: stored [n][depth]
      for (int i = tid; i < kTileN * (kDepth / 8); i += kThreads) {
        const int nn = i / (kDepth / 8), ch = i % (kDepth / 8), n = n0 + nn;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (n < p.N) v = *reinterpret_cast<const uint4*>(rhs + n * p.rhs_sn + k0 + ch * 8);
        *reinterpret_cast<uint4*>(b_s + nn * kStrideDepth + ch * 8) = v;
      }
    }
    __syncthreads();

#pragma unroll
    for (int kc = 0; kc < kDepth / 16; ++kc) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const __nv_bfloat16* p0 = a_s + (wm + mt * 16 + g) * kStrideDepth + kc * 16 + t * 2;
        const __nv_bfloat16* p1 = p0 + 8 * kStrideDepth;
        a[mt][0] = ld32(p0);
        a[mt][1] = ld32(p1);
        a[mt][2] = ld32(p0 + 8);
        a[mt][3] = ld32(p1 + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t b0, b1;
        if constexpr (kRhsNContig) {  // pairs along depth are two 16-bit reads
          const uint16_t* x = reinterpret_cast<const uint16_t*>(b_s) +
                              (kc * 16 + t * 2) * kStrideTile + wn + nt * 8 + g;
          b0 = uint32_t(x[0]) | (uint32_t(x[kStrideTile]) << 16);
          b1 = uint32_t(x[8 * kStrideTile]) | (uint32_t(x[9 * kStrideTile]) << 16);
        } else {
          const __nv_bfloat16* br = b_s + (wn + nt * 8 + g) * kStrideDepth + kc * 16 + t * 2;
          b0 = ld32(br);
          b1 = ld32(br + 8);
        }
        mma_16816(acc[0][nt], a[0], b0, b1);
        mma_16816(acc[1][nt], a[1], b0, b1);
      }
    }
    __syncthreads();  // the next step overwrites a_s / b_s
  }

#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = n0 + wn + nt * 8 + t * 2;
    if (col >= p.N) continue;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = wm + mt * 16 + g;
      *reinterpret_cast<uint32_t*>(out + int64_t(r) * p.N + col) = pack_bf16(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<uint32_t*>(out + int64_t(r + 8) * p.N + col) = pack_bf16(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

struct TgmmParams {
  const __nv_bfloat16* lhs;   // [M, K], row stride lhs_sm, unit stride over K
  const __nv_bfloat16* dout;  // [M, N], row stride dout_sm, unit stride over N
  const int* group_sizes;     // [E] padded (128-aligned) row counts
  __nv_bfloat16* out;         // [E, K, N] contiguous
  int M, K, N, E;
  int64_t lhs_sm, dout_sm;
};

// One (128 K rows, 128 N columns) tile of out[e]: the sum over expert e's
// rows r of lhs[r, k] * dout[r, n]. Both operands are staged [row][col] with
// the rows as the contraction; the A fragment (rows k, columns r) and the B
// fragment (depth r, columns n) are read as pairs of 16-bit values along r.
__global__ void __launch_bounds__(kThreads) tgmm_kernel(const TgmmParams p) {
  __shared__ __align__(16) __nv_bfloat16 l_s[kDepth * kStrideTile];  // [row][k]
  __shared__ __align__(16) __nv_bfloat16 d_s[kDepth * kStrideTile];  // [row][n]

  const int k_lo = blockIdx.x * kTileN, n_lo = blockIdx.y * kTileN, e = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 64;  // this warp's K rows and N columns

  // this expert's aligned start and padded size
  int start = 0;
  for (int j = 0; j < e; ++j) start += p.group_sizes[j];
  const int end = min(start + p.group_sizes[e], p.M);

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  const uint16_t* ls = reinterpret_cast<const uint16_t*>(l_s);
  const uint16_t* ds = reinterpret_cast<const uint16_t*>(d_s);
  for (int r0 = start; r0 < end; r0 += kDepth) {
    for (int i = tid; i < kDepth * (kTileN / 8); i += kThreads) {
      const int rr = i / (kTileN / 8), ch = i % (kTileN / 8), r = r0 + rr;
      const int k = k_lo + ch * 8, n = n_lo + ch * 8;
      uint4 lv = make_uint4(0u, 0u, 0u, 0u), dv = lv;
      if (r < end && k < p.K) lv = *reinterpret_cast<const uint4*>(p.lhs + r * p.lhs_sm + k);
      if (r < end && n < p.N) dv = *reinterpret_cast<const uint4*>(p.dout + r * p.dout_sm + n);
      *reinterpret_cast<uint4*>(l_s + rr * kStrideTile + ch * 8) = lv;
      *reinterpret_cast<uint4*>(d_s + rr * kStrideTile + ch * 8) = dv;
    }
    __syncthreads();

#pragma unroll
    for (int kc = 0; kc < kDepth / 16; ++kc) {
      const int r_lo = kc * 16 + t * 2;  // this thread's first contraction row
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint16_t* x = ls + r_lo * kStrideTile + wm + mt * 16 + g;
        a[mt][0] = uint32_t(x[0]) | (uint32_t(x[kStrideTile]) << 16);                 // (k g, r 2t..)
        a[mt][1] = uint32_t(x[8]) | (uint32_t(x[kStrideTile + 8]) << 16);             // (k g+8, r 2t..)
        a[mt][2] = uint32_t(x[8 * kStrideTile]) | (uint32_t(x[9 * kStrideTile]) << 16);  // (k g, r 2t+8..)
        a[mt][3] = uint32_t(x[8 * kStrideTile + 8]) | (uint32_t(x[9 * kStrideTile + 8]) << 16);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const uint16_t* x = ds + r_lo * kStrideTile + wn + nt * 8 + g;
        const uint32_t b0 = uint32_t(x[0]) | (uint32_t(x[kStrideTile]) << 16);
        const uint32_t b1 = uint32_t(x[8 * kStrideTile]) | (uint32_t(x[9 * kStrideTile]) << 16);
        mma_16816(acc[0][nt], a[0], b0, b1);
        mma_16816(acc[1][nt], a[1], b0, b1);
      }
    }
    __syncthreads();  // the next step overwrites l_s / d_s
  }

  // written once, zeros for an expert with no rows
  __nv_bfloat16* out = p.out + int64_t(e) * p.K * p.N;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = n_lo + wn + nt * 8 + t * 2;
    if (col >= p.N) continue;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int k = k_lo + wm + mt * 16 + g;
      if (k < p.K)
        *reinterpret_cast<uint32_t*>(out + int64_t(k) * p.N + col) = pack_bf16(acc[mt][nt][0], acc[mt][nt][1]);
      if (k + 8 < p.K)
        *reinterpret_cast<uint32_t*>(out + int64_t(k + 8) * p.N + col) = pack_bf16(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

}  // namespace

// C entry points, loaded with ctypes. Each launches on `stream`, does not
// synchronise and allocates nothing; each returns cudaGetLastError() so the
// caller sees a refused launch at once. Shapes: M a multiple of 128, K and N
// multiples of 64 (the wrapper checks; a bad shape returns an error here).
extern "C" int gmm_bf16(const void* lhs, const void* rhs, const void* blk_e, const void* act, void* out,
                        int M, int K, int N, int64_t lhs_sm, int64_t rhs_se, int64_t rhs_sk,
                        int64_t rhs_sn, void* stream) {
  if (M % kBlockM || K % kDepth || N % 64) return int(cudaErrorInvalidValue);
  if (rhs_sn != 1 && rhs_sk != 1) return int(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return int(cudaSuccess);
  GmmParams p;
  p.lhs = static_cast<const __nv_bfloat16*>(lhs);
  p.rhs = static_cast<const __nv_bfloat16*>(rhs);
  p.blk_e = static_cast<const int*>(blk_e);
  p.act = static_cast<const int*>(act);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.M = M; p.K = K; p.N = N;
  p.lhs_sm = lhs_sm; p.rhs_se = rhs_se; p.rhs_sk = rhs_sk; p.rhs_sn = rhs_sn;
  const dim3 grid(M / kBlockM, (N + kTileN - 1) / kTileN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rhs_sn == 1) {
    gmm_kernel<true><<<grid, kThreads, 0, s>>>(p);
  } else {
    gmm_kernel<false><<<grid, kThreads, 0, s>>>(p);
  }
  return int(cudaGetLastError());
}

extern "C" int tgmm_bf16(const void* lhs, const void* dout, const void* group_sizes, void* out, int M,
                         int K, int N, int E, int64_t lhs_sm, int64_t dout_sm, void* stream) {
  if (M % kBlockM || K % 64 || N % 64) return int(cudaErrorInvalidValue);
  if (E == 0 || K == 0 || N == 0) return int(cudaSuccess);
  TgmmParams p;
  p.lhs = static_cast<const __nv_bfloat16*>(lhs);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.group_sizes = static_cast<const int*>(group_sizes);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.M = M; p.K = K; p.N = N; p.E = E;
  p.lhs_sm = lhs_sm; p.dout_sm = dout_sm;
  const dim3 grid((K + kTileN - 1) / kTileN, (N + kTileN - 1) / kTileN, E);
  tgmm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}
