// Grouped matmul and its transpose for Hopper (sm_90a): bf16 operands,
// fp32 accumulation, bf16 results. The compute of the dropless MoE layer.
//
// Replaces the two Pallas TPU kernels of contrastors_tpu/ops/grouped_matmul.py:
//   _gmm_kernel  (:75, call _gmm_call :92)   -> gmm_kernel<false> (the
//       forward: rhs [E, K, N] with unit stride over N) and gmm_kernel<true>
//       (dlhs: the rhs.transpose(1, 2) view, unit stride over K),
//   _tgmm_kernel (:125, call _tgmm_call :156) -> tgmm_kernel.
// Rows are laid out by expert with every group start aligned to 128 rows
// (block_m), so each 128-row block of lhs belongs to one expert:
//   gmm:  out[block i] = lhs[block i] @ rhs[blk_e[i]], and 0 where act[i] == 0
//         (blocks past the last group are padding);
//   tgmm: out[e] = sum over e's rows of lhs_r^T dout_r, 0 for an expert with
//         no rows.
//
// What bounds them on an H100: 2*K*N FLOP per active row against lhs, the
// expert panels and out moved once; at the MoE layer's shapes (K, N = 768,
// 3072 and 3072, 768, thousands of rows) about 1000 FLOP per byte, above the
// card's ~295 FLOP/byte balance for bf16, so the tensor cores bound both.
// Only wgmma reaches their full rate, and only when its operands arrive in
// shared memory ahead of it. Between device memory and the tensor cores
// the next limit is L2: a tile loads (rows + columns) x 64 x 2 bytes per
// 64-deep stage for rows x columns x 128 FLOP, so the tile is made as wide
// as the registers allow. The design:
//   - A block owns output tiles of 128 x 256: 128 rows of one expert block
//     (tgmm: 128 K rows of one expert) by 256 columns. Two consumer
//     warpgroups each run wgmma.mma_async m64n256k16 (bf16 in, 128 fp32
//     accumulators per thread) over their 64 rows; a producer warp keeps a
//     ring of four 64-deep stages (48 KB each) filled by TMA
//     (cp.async.bulk.tensor, 128-byte swizzle), guarded by a full and an
//     empty mbarrier per stage. Consumers release a stage once the wgmma
//     group after it is issued (wait_group 1), so loads, products and the
//     next stage's wait overlap. 225 KB of dynamic shared memory and 288
//     threads: one block per SM.
//   - Operands are read in their stored layout, never transposed by a copy:
//     lhs of gmm and dlhs's rhs view are K-major (rows of 128 bytes); the
//     forward's rhs, and both operands of tgmm, are MN-major, read through
//     wgmma's transpose bits (legal for bf16). A 128-byte swizzle box is 64
//     bf16 wide, so a 256-wide MN-major tile is four boxes, 8 KB apart (the
//     descriptor's leading byte offset).
//   - Tensor maps: lhs and dout 2-D from their row strides; rhs 3-D over its
//     [E, K, N] storage (or the transposed view's), the block's expert the
//     third coordinate; out 2-D (tgmm: 3-D, so a K edge stays in its
//     expert). TMA fills what lies past N (or K) with zeros on load and
//     clips it on store, so an edge tile (N a multiple of 64, not of 256)
//     runs the same code.
//   - Epilogue: each warpgroup casts its rows to bf16, 64 columns at a
//     time, into one of two swizzled 8 KB staging boxes and stores the box
//     by TMA; the store drains while the next box is cast and, in gmm,
//     while the next tile's products run. (Stores straight from the
//     accumulators, or through one staging tile in the drained ring, left
//     the tensor cores idle for the whole epilogue: PERF.md.)
//   - gmm is persistent: one block per SM walks the tiles (N tiles of one M
//     block adjacent, so an M block's rows and its expert's panel are read
//     from L2 by blocks in flight together), and the ring runs on across
//     tiles, so the next tile's loads overlap this tile's epilogue. An
//     inactive block's tile is zero-filled without loads.
//   - tgmm's blocks take the experts largest first, all tiles of one expert
//     together (each block finds its expert's rank from group_sizes): every
//     block loops over all of its expert's rows, so with skewed routing the
//     longest tiles start first and the short ones fill in behind them (the
//     hardware hands out blocks in order; a persistent grid with a fixed
//     assignment would lose that), instead of the largest expert's tiles
//     setting the tail of the launch. One owner per output tile, sums in a
//     fixed order: no atomics, deterministic. An empty expert's tiles (last
//     in the order) write zeros. One launch per call.

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int kBlockM = 128;    // rows of an expert block (gmm); K rows of a tile (tgmm)
constexpr int kTileN = 256;     // output columns of a tile
constexpr int kDepth = 64;      // contraction per stage: 64 bf16 = one 128-byte swizzle row
constexpr int kStages = 4;      // ring depth
constexpr int kConsumers = 2;   // warpgroups, 64 output rows each
constexpr int kThreads = kConsumers * 128 + 32;  // + one producer warp
constexpr int kAcc = kTileN / 2;                 // fp32 accumulators per consumer thread
constexpr int kBox = 64 * kDepth * 2;            // 8 KB: a 64 x 64 bf16 box
constexpr int kABytes = kBlockM * kDepth * 2;    // A (128 x 64) at the start of a stage
constexpr int kStageBytes = kABytes + kTileN * kDepth * 2;  // + B (64 x 256)
constexpr int kStagingOffset = kStages * kStageBytes;  // the epilogue's two boxes per warpgroup
constexpr int kBarrierOffset = kStagingOffset + kConsumers * 2 * kBox;
constexpr int kSmemBytes = 1024 + kBarrierOffset + 2 * kStages * 8;  // + alignment slack + barriers

// Keep the compiler from moving accumulator reads or writes across a
// wgmma fence or wait.
__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define GMM_ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define GMM_ACC16(i) GMM_ACC4(i), GMM_ACC4(i + 4), GMM_ACC4(i + 8), GMM_ACC4(i + 12)

// d[64 x 256] += A[64 x 16] B[16 x 256], both from shared memory. kTransA /
// kTransB: 0 = K-major, 1 = MN-major. Accumulator layout (thread t of the
// warpgroup, warp w = t / 32, lane l): d[4j + 2h + c] is row 16w + l/4 + 8h,
// column 8j + 2(l % 4) + c.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[kAcc], uint64_t desc_a, uint64_t desc_b) {
  static_assert(kAcc == 128, "m64n256k16 holds 128 accumulators per thread");
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
      : GMM_ACC16(0), GMM_ACC16(16), GMM_ACC16(32), GMM_ACC16(48),
        GMM_ACC16(64), GMM_ACC16(80), GMM_ACC16(96), GMM_ACC16(112)
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(kTransA), "n"(kTransB));
}

#undef GMM_ACC16
#undef GMM_ACC4

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- the pieces every kernel shares ------------------------------------

struct Ring {
  uint32_t base;  // shared address of the (1024-aligned) ring
  uint32_t full, empty;  // the barriers of stage 0; stage s at + 8 s
};

// Align the ring, and let one thread set up the barriers: full[s] waits for
// the producer's arrival and the stage's bytes, empty[s] for one arrival
// per consumer warpgroup.
__device__ __forceinline__ Ring ring_init(uint8_t* smem) {
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  Ring r{base, base + kBarrierOffset, base + kBarrierOffset + kStages * 8};
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(r.full + 8 * s, 1);
      mbar_init(r.empty + 8 * s, kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();
  return r;
}

// The producer's step i: wait for the stage to be free, then announce its
// bytes; returns the stage's shared address and its full barrier.
__device__ __forceinline__ uint32_t produce(const Ring& r, int i, uint32_t* bar) {
  const int s = i % kStages;
  mbar_wait(r.empty + 8 * s, ((i / kStages) & 1) ^ 1);
  *bar = r.full + 8 * s;
  mbar_expect_tx(*bar, kStageBytes);
  return r.base + s * kStageBytes;
}

// The consumers' main loop over nk stages, the ring's steps it0 .. it0 +
// nk - 1. Stage layout: A at +0 (this warpgroup's 64 rows at + wg *
// a_wg_offset), B at + kABytes. Every stage is released once its products
// are done.
template <int kTransA, int kTransB>
__device__ __forceinline__ void consume(const Ring& r, int it0, int nk, int wg, uint32_t a_wg_offset,
                                        float (&acc)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  fence_acc(acc);
  constexpr uint32_t a_step = kTransA ? kMNMajorStep : kKMajorStep;
  constexpr uint32_t b_step = kTransB ? kMNMajorStep : kKMajorStep;
  const bool signals = threadIdx.x % 128 == 0;  // one arrival per warpgroup
  for (int i = it0; i < it0 + nk; ++i) {
    const int s = i % kStages;
    mbar_wait(r.full + 8 * s, (i / kStages) & 1);
    const uint32_t a = r.base + s * kStageBytes + wg * a_wg_offset;
    const uint32_t b = r.base + s * kStageBytes + kABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDepth / 16; ++kk) {
      wgmma_m64n256k16<kTransA, kTransB>(acc, sw128_desc(a + kk * a_step, kBox, 1024),
                                         sw128_desc(b + kk * b_step, kBox, 1024));
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: release it
    if (i > it0 && signals) mbar_arrive(r.empty + 8 * ((i - 1) % kStages));
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (nk > 0 && signals) mbar_arrive(r.empty + 8 * ((it0 + nk - 1) % kStages));
}

// Store this warpgroup's 64 x 256 accumulators as bf16 through TMA, as
// four 64 x 64 boxes of out's tensor map at (col0 + 64 j, row0 + 64 wg[, z]).
// Each box is cast into one of the warpgroup's two 128-byte-swizzled
// staging buffers (conflict-free: a row's 16-byte chunks are permuted by
// row % 8) and stored asynchronously, so one box drains while the next is
// cast and, in gmm, while the next tile's products run. TMA clips what lies
// past the map's extents (the edge columns, tgmm's K edge).
template <int kRank>
__device__ __forceinline__ void store_tile(const Ring& r, const float (&acc)[kAcc], int wg, const CUtensorMap* map,
                                           int col0, int row0, int z) {
  const int t = threadIdx.x % 128, lane = t % 32, q = lane % 4;
  const int row = (t / 32) * 16 + lane / 4;  // and row + 8; row % 8 == (row + 8) % 8 == lane / 4
  const int swz = row & 7;
  const bool leader = t == 0;
#pragma unroll
  for (int j = 0; j < kTileN / 64; ++j) {
    const uint32_t buf = r.base + kStagingOffset + (wg * 2 + (j & 1)) * kBox;
    if (leader) bulk_wait_read<1>();  // the store that last used this buffer has read it
    named_bar_sync(2 + wg);
#pragma unroll
    for (int c = 0; c < 8; ++c) {  // the box's 8-column groups
      const int a = 4 * (8 * j + c);
      st_shared_u32(buf + row * 128 + ((c ^ swz) << 4) + 4 * q, pack_bf16(acc[a], acc[a + 1]));
      st_shared_u32(buf + (row + 8) * 128 + ((c ^ swz) << 4) + 4 * q, pack_bf16(acc[a + 2], acc[a + 3]));
    }
    fence_proxy_async();  // the generic writes, before the async proxy reads them
    named_bar_sync(2 + wg);
    if (leader) {
      if constexpr (kRank == 2) {
        tma_store_2d(map, buf, col0 + 64 * j, row0 + 64 * wg);
      } else {
        tma_store_3d(map, buf, col0 + 64 * j, row0 + 64 * wg, z);
      }
      bulk_commit();
    }
  }
}

// ---- the kernels --------------------------------------------------------

struct GmmParams {
  const int* blk_e;    // [M / 128] expert of each block
  const int* act;      // [M / 128] 1 = active, 0 = padding block
  __nv_bfloat16* out;  // [M, N] contiguous
  int M, K, N;
};

// Persistent: block b takes tiles b, b + gridDim.x, ... of the (M / 128) x
// (N / 256) tiles of out, the N tiles of an M block adjacent. The ring runs
// on across tiles, so the producer loads the next tile while the consumers
// cast and store this one. lhs_map: 2-D {K, M}, box {64, 128}. rhs_map:
// kRhsKMajor ? 3-D {K, N, E}, box {64, 256, 1} (dlhs's transposed view)
//            : 3-D {N, K, E}, box {64, 64, 1}, four boxes per stage.
// out_map: 2-D {N, M}, box {64, 64}.
template <bool kRhsKMajor>
__global__ void __launch_bounds__(kThreads, 1)
    gmm_kernel(const __grid_constant__ CUtensorMap lhs_map, const __grid_constant__ CUtensorMap rhs_map,
               const __grid_constant__ CUtensorMap out_map, const GmmParams p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const int n_tiles = (p.N + kTileN - 1) / kTileN, tiles = (p.M / kBlockM) * n_tiles, nk = p.K / kDepth;
  const Ring r = ring_init(smem);

  if (threadIdx.x >= kConsumers * 128) {  // the producer warp
    if (threadIdx.x == kConsumers * 128) {
      prefetch_map(&lhs_map);
      prefetch_map(&rhs_map);
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int blk = tile / n_tiles, n0 = (tile % n_tiles) * kTileN;
        if (p.act[blk] == 0) continue;
        const int e = p.blk_e[blk];
        for (int i = 0; i < nk; ++i, ++it) {
          uint32_t bar;
          const uint32_t a = produce(r, it, &bar), b = a + kABytes;
          tma_load_2d(a, &lhs_map, bar, i * kDepth, blk * kBlockM);
          if constexpr (kRhsKMajor) {
            tma_load_3d(b, &rhs_map, bar, i * kDepth, n0, e);
          } else {
#pragma unroll
            for (int j = 0; j < kTileN / 64; ++j) tma_load_3d(b + j * kBox, &rhs_map, bar, n0 + 64 * j, i * kDepth, e);
          }
        }
      }
    }
    return;
  }
  const int wg = threadIdx.x / 128;
  if (threadIdx.x % 128 == 0) prefetch_map(&out_map);
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int blk = tile / n_tiles, n0 = (tile % n_tiles) * kTileN;
    if (p.act[blk] == 0) {  // a padding block: zeros, no loads
      __nv_bfloat16* out = p.out + int64_t(blk) * kBlockM * p.N + n0;
      const int cols = min(kTileN, p.N - n0);
      for (int i = threadIdx.x; i < kBlockM * (kTileN / 8); i += kConsumers * 128) {
        const int rr = i / (kTileN / 8), c = (i % (kTileN / 8)) * 8;
        if (c < cols) *reinterpret_cast<uint4*>(out + int64_t(rr) * p.N + c) = make_uint4(0u, 0u, 0u, 0u);
      }
      continue;
    }
    float acc[kAcc];
    // A: 128 K-major rows of 128 B, this warpgroup's 64 at + 8 KB
    consume<0, kRhsKMajor ? 0 : 1>(r, it, nk, wg, 64 * 128, acc);
    it += nk;
    store_tile<2>(r, acc, wg, &out_map, n0, blk * kBlockM, 0);
  }
  if (threadIdx.x % 128 == 0) bulk_wait_read<0>();  // shared memory outlives the last store's reads
}

struct TgmmParams {
  const int* group_sizes;  // [E] padded (128-aligned) row counts
  __nv_bfloat16* out;      // [E, K, N] contiguous
  int M, K, N, E;
};

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

// One 128 (K) x 256 (N) tile of out[e]: the sum over e's rows r of
// lhs[r, k] * dout[r, n], 64 rows per stage. lhs_map: 2-D {K, M}, dout_map:
// 2-D {N, M}, both box {64, 64}; two lhs and four dout boxes per stage, both
// MN-major (A = lhs^T, B = dout). out_map: 3-D {N, K, E}, box {64, 64, 1}.
__global__ void __launch_bounds__(kThreads, 1)
    tgmm_kernel(const __grid_constant__ CUtensorMap lhs_map, const __grid_constant__ CUtensorMap dout_map,
                const __grid_constant__ CUtensorMap out_map, const TgmmParams p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  __shared__ int chosen;
  const int n_tiles = (p.N + kTileN - 1) / kTileN, tiles = ((p.K + kBlockM - 1) / kBlockM) * n_tiles;
  const int e = expert_of_rank(p.group_sizes, p.E, blockIdx.x / tiles, &chosen), tile = blockIdx.x % tiles;
  const int k0 = (tile / n_tiles) * kBlockM, n0 = (tile % n_tiles) * kTileN;
  int start = 0;
  for (int j = 0; j < e; ++j) start += p.group_sizes[j];
  const int nk = max(0, min(p.group_sizes[e], p.M - start)) / kDepth;

  const Ring r = ring_init(smem);
  if (threadIdx.x >= kConsumers * 128) {  // the producer warp
    if (threadIdx.x == kConsumers * 128) {
      prefetch_map(&lhs_map);
      prefetch_map(&dout_map);
      for (int i = 0; i < nk; ++i) {
        uint32_t bar;
        const uint32_t a = produce(r, i, &bar), b = a + kABytes;
        const int row = start + i * kDepth;
        tma_load_2d(a, &lhs_map, bar, k0, row);
        tma_load_2d(a + kBox, &lhs_map, bar, k0 + 64, row);
#pragma unroll
        for (int j = 0; j < kTileN / 64; ++j) tma_load_2d(b + j * kBox, &dout_map, bar, n0 + 64 * j, row);
      }
    }
    return;
  }
  const int wg = threadIdx.x / 128;
  float acc[kAcc];
  // A: this warpgroup's 64 K rows are one box
  consume<1, 1>(r, 0, nk, wg, kBox, acc);
  store_tile<3>(r, acc, wg, &out_map, n0, k0, e);
  if (threadIdx.x % 128 == 0) bulk_wait_read<0>();  // shared memory outlives the stores' reads
}

// ---- host side ----------------------------------------------------------

// Dynamic shared memory above 48 KB (kSmemBytes, ~225 KB: one block
// per SM), and the carveout that gives shared memory the most; set once
// per kernel.
template <class Kernel>
cudaError_t prepare(Kernel kernel, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  *done = err == cudaSuccess;
  return err;
}

bool prepared[3];

}  // namespace

// C entry points, loaded with ctypes. Each launches on `stream`, does not
// synchronise and allocates nothing; each returns cudaGetLastError() (or
// the error that stopped it first) so the caller sees a refused launch at
// once. Shapes: M a multiple of 128, K and N multiples of 64; pointers 16-
// byte aligned, row and expert strides multiples of 8 elements (TMA; the
// wrapper checks). A bad shape returns cudaErrorInvalidValue.
extern "C" int gmm_bf16(const void* lhs, const void* rhs, const void* blk_e, const void* act, void* out, int M,
                        int K, int N, int E, int64_t lhs_sm, int64_t rhs_se, int64_t rhs_sk, int64_t rhs_sn,
                        void* stream) {
  if (M % kBlockM || K % kDepth || N % 64 || E <= 0) return int(cudaErrorInvalidValue);
  if (rhs_sn != 1 && rhs_sk != 1) return int(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return int(cudaSuccess);
  GmmParams p;
  p.blk_e = static_cast<const int*>(blk_e);
  p.act = static_cast<const int*>(act);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.M = M; p.K = K; p.N = N;
  if (K == 0) return int(cudaMemsetAsync(out, 0, size_t(M) * N * 2, static_cast<cudaStream_t>(stream)));
  CUtensorMap lhs_map, rhs_map;
  const int64_t l_dims[2] = {K, M}, l_strides[1] = {lhs_sm};
  const int l_box[2] = {kDepth, kBlockM};
  if (!make_map(&lhs_map, lhs, 2, l_dims, l_strides, l_box)) return int(cudaErrorInvalidValue);
  const bool k_major = rhs_sn != 1;
  const int64_t r_dims[3] = {k_major ? K : N, k_major ? N : K, E};
  const int64_t r_strides[2] = {k_major ? rhs_sn : rhs_sk, rhs_se};
  const int r_box_kmajor[3] = {kDepth, kTileN, 1}, r_box_nmajor[3] = {64, kDepth, 1};
  if (!make_map(&rhs_map, rhs, 3, r_dims, r_strides, k_major ? r_box_kmajor : r_box_nmajor))
    return int(cudaErrorInvalidValue);
  CUtensorMap out_map;
  const int64_t o_dims[2] = {N, M}, o_strides[1] = {N};
  const int o_box[2] = {64, 64};
  if (!make_map(&out_map, out, 2, o_dims, o_strides, o_box)) return int(cudaErrorInvalidValue);
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(min((M / kBlockM) * ((N + kTileN - 1) / kTileN), sms));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k_major) {
    if ((err = prepare(gmm_kernel<true>, &prepared[1])) != cudaSuccess) return int(err);
    gmm_kernel<true><<<grid, kThreads, kSmemBytes, s>>>(lhs_map, rhs_map, out_map, p);
  } else {
    if ((err = prepare(gmm_kernel<false>, &prepared[0])) != cudaSuccess) return int(err);
    gmm_kernel<false><<<grid, kThreads, kSmemBytes, s>>>(lhs_map, rhs_map, out_map, p);
  }
  return int(cudaGetLastError());
}

extern "C" int tgmm_bf16(const void* lhs, const void* dout, const void* group_sizes, void* out, int M, int K,
                         int N, int E, int64_t lhs_sm, int64_t dout_sm, void* stream) {
  if (M % kBlockM || K % 64 || N % 64) return int(cudaErrorInvalidValue);
  if (E == 0 || K == 0 || N == 0) return int(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0) return int(cudaMemsetAsync(out, 0, size_t(E) * K * N * 2, s));
  TgmmParams p;
  p.group_sizes = static_cast<const int*>(group_sizes);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.M = M; p.K = K; p.N = N; p.E = E;
  CUtensorMap lhs_map, dout_map;
  const int box[2] = {64, kDepth};
  const int64_t l_dims[2] = {K, M}, l_strides[1] = {lhs_sm};
  const int64_t d_dims[2] = {N, M}, d_strides[1] = {dout_sm};
  CUtensorMap out_map;
  const int64_t o_dims[3] = {N, K, E}, o_strides[2] = {N, int64_t(K) * N};
  const int o_box[3] = {64, 64, 1};
  if (!make_map(&lhs_map, lhs, 2, l_dims, l_strides, box) || !make_map(&dout_map, dout, 2, d_dims, d_strides, box) ||
      !make_map(&out_map, out, 3, o_dims, o_strides, o_box))
    return int(cudaErrorInvalidValue);
  cudaError_t err;
  if ((err = prepare(tgmm_kernel, &prepared[2])) != cudaSuccess) return int(err);
  const dim3 grid(E * ((K + kBlockM - 1) / kBlockM) * ((N + kTileN - 1) / kTileN));
  tgmm_kernel<<<grid, kThreads, kSmemBytes, s>>>(lhs_map, dout_map, out_map, p);
  return int(cudaGetLastError());
}
