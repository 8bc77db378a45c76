// Flash attention forward and backward in fp32 on the tensor cores, in 3xTF32,
// at every head dim the Pallas kernels take: D % 8 == 0 with D <= 256, fp32
// LSE. What this file shares with the bf16 kernels of flash_generic.cu
// (arguments, masks, rotary, ranges, copies, and the semantics) is in
// flash_generic_common.cuh.
//
// Replaces, for fp32 inputs, the Pallas TPU kernels of
// contrastors_tpu/ops/flash_attention.py:
//   flash_tf32_fwd - _fwd_kernel_single (:225) and _fwd_kernel (:115), call :396,
//   flash_tf32_dq  - _bwd_dq_kernel (:422), call :640,
//   flash_tf32_dkv - _bwd_dkv_kernel (:512), call :700,
// with their fused_rot=True forms (_rot_block :76, _rot_adjoint :87) as a
// run-time choice: a NULL cos table means no rotary.
//
// What bounds them on an H100: the products. At the fp32 steps' shapes (S =
// T = 256 or 512, D = 64) each reads and writes a few MB against 4 to 8 S T D
// FLOP per (batch, head): some T/4 FLOP per byte, above the card's balance.
// TF32 on the tensor cores runs at 495 TFLOP/s but keeps 10 mantissa bits;
// fp32 FMAs keep 23 at 67 TFLOP/s. 3xTF32 keeps about fp32's precision at
// 495 / 3 ~ 165 TFLOP/s: each operand x is split into big = rna_tf32(x) and
// small = rna_tf32(x - big) (x - big is exact), and a b is summed as small_a
// big_b + big_a small_b + big_a big_b, in that order, into one fp32
// accumulator (CUTLASS's OpMultiplyAddFastF32, which PyTorch's fp32 SDPA runs
// on sm80 and later). The dropped small_a small_b and the rounding of the
// small parts leave about 2^-21 of each product.
//
// What the designs do about it: every product is mma.sync.m16n8k8 tf32 in
// 3xTF32, on operands that stay fp32 in shared memory in rows of D + 4 floats
// (a stride = 4 (mod 8): the fragment reads x[g][t] and x[2t][g], x[2t + 1][g]
// fall in 32 distinct banks) and are split as they are read. Splitting, more
// than the products, is the cost (the forward's note has the probes), so each
// split fragment serves as many products as the registers allow: an A
// fragment every n tile of a product, a B fragment every m tile. A product's
// result feeds the next product straight from the accumulator registers, its
// columns 2t, 2t + 1 being the k slots t, t + 4 of an A fragment (the k index
// permuted: a B row 2t is read as slot t, 2t + 1 as slot t + 4). Rows arrive
// by 16-byte cp.async where they are 16-byte aligned (Args.vec), else staged
// through registers, as are rotated q / k rows (rotated as the plain version
// rotates). The head dim is bucketed (64, 128, 256: a template parameter that
// sizes the accumulators); D itself is a run-time value and every 8-wide step
// past it is skipped, so nothing is zero-padded and no product runs on
// padding. Every output element has one owner and a fixed order of sums: no
// atomics, bit-identical reruns.

#include "flash_generic_common.cuh"

namespace {

// ---- the forward --------------------------------------------------------------
//
// fwd_tf32_kernel<DMAX> takes the inputs of flash_tf32_fwd. It
// replaces, for them, _fwd_kernel_single (contrastors_tpu/ops/flash_attention.py
// :225) and _fwd_kernel (:115), call :396, with fused_rot (_rot_block :76).
//
// What bounds it on an H100: the products, at 3xTF32's rate (this file's
// note). A first design, fp32 FMAs over operands in shared memory, took 2.7x
// SDPA's time.
//
// What the design does about it (fwd_tc_kernel's loop at fp32). Splitting
// the operands, not the products, is the cost to cut: at the fp32 document
// chunk on an H100 (tools/generic_kernel_probe.py, device ms), unsplit
// operands ran in 0.077 ms and one TF32 product in 0.062, three products on
// split operands in 0.122 at 16 query rows a warp, and 0.094 at 32 rows a
// warp, each K / V fragment split once for both.
//   - 4 warps own 16 MT query rows each of one (batch, head) (MT = 2 at
//     DMAX 64, 1 above, where O takes 64-128 registers a thread) and walk kv
//     tiles of BKV rows (32 at DMAX 64 and 256, 64 at 128) over kv_range,
//     narrowed to the keys whose segment id some row of the block holds: a
//     tile outside that span has p = 0 exactly (its max leaves m, alpha =
//     1), so skipping it changes no output, and a padded row's keys and
//     query blocks cost nothing. A tile whose keys all hold the block's one
//     nonzero segment id is not masked element by element (rows of id 0 are
//     set empty at the end, as the mask would leave them);
//   - S = Q K^T and O += P V run on mma.sync.m16n8k8 tf32, three products
//     each; operands stay fp32 in shared memory in rows of D + 4 floats (a
//     stride = 4 (mod 8): the fragment reads Q[g][t], K[g][t] and V[2t][g],
//     V[2t + 1][g] fall in 32 distinct banks) and are split as they are
//     read, by cvt.rna.tf32.f32's rounding (to nearest, ties away) done on
//     the integer pipe; each K / V fragment split serves the warp's MT m
//     tiles, and the products of MT x 4 accumulators are issued pass by
//     pass, so that no product waits on the one before it;
//   - the online softmax runs in registers on the S accumulators, and P
//     feeds P V from them without shared memory: the accumulator holds
//     columns 2t, 2t + 1 where the A fragment wants t, t + 4, so the
//     contraction index is permuted (k slot t <- kv 2t, slot t + 4 <- kv
//     2t + 1: V's rows 2t and 2t + 1 are B's b0 and b1);
//   - one K and one V buffer: V's copy runs under Q K^T, the next K's under
//     P V. Rows arrive by 16-byte cp.async where they are 16-byte aligned
//     (Args.vec), else staged through registers, as are rotated q / k tiles
//     (rotated as the plain version rotates);
//   - the head dim is bucketed (64, 128, 256: a template parameter that
//     sizes O's registers); D itself is a run-time value and every 8-wide
//     step past it is skipped, so nothing is zero-padded and no product runs
//     on padding. Blocks a SM (registers): 3 at DMAX 64, 2 at 128, 1 at 256.
// Every O element has one owner and a fixed order of sums: no atomics,
// bit-identical reruns. The fp32 dq and dk/dv below take this kernel's LSE.

constexpr int kFwdF32Threads = 128;  // 4 warps
template <int DMAX>
constexpr int kTf32M = DMAX > 64 ? 1 : 2;  // 16-row m tiles a warp owns: the block's query rows are 64 kTf32M
template <int DMAX>
constexpr int kTf32Kv = DMAX > 128 || DMAX == 64 ? 32 : 64;  // kv rows of a walked tile
template <int DMAX>
constexpr int kTf32Blocks = DMAX > 128 ? 1 : (DMAX > 64 ? 2 : 3);  // blocks a SM the registers must allow

size_t fwd_tf32_bytes(int D, int rows, int bkv) {
  return size_t(rows + 2 * bkv) * (D + 4) * sizeof(float) + (rows + bkv + 4) * sizeof(int);
}

// cvt.rna.tf32.f32 on the integer pipe: x rounded to TF32's 10 mantissa
// bits, to nearest with ties away from zero, the 13 low bits cleared
__device__ __forceinline__ uint32_t rna_tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = rna_tf32(x);
  small = rna_tf32(x - __uint_as_float(big));
}
// ROWS fp32 rows row0 .. of one (batch, head) of x (row stride ss) into dst
// (row stride ld floats), columns [0, D); rows past n_valid are zero. By
// 16-byte cp.async when `async`, else staged through registers, rotated
// (q, k) as the plain version rotates when `rotate`.
template <int NT, int DMAX, int ROWS>
__device__ __forceinline__ void tile_load_f32(float* dst, int ld, const float* base, int64_t ss, int row0,
                                              int n_valid, int D, bool async, bool rotate, const Rot& rot, int b) {
  if (async && !rotate) {
    constexpr int SLOTS = DMAX / 4;  // 16-byte slots of a row, D / 4 of them used
    static_assert(ROWS * SLOTS % NT == 0, "every thread issues the same number of copies");
#pragma unroll
    for (int it = 0; it < ROWS * SLOTS / NT; ++it) {
      const int idx = threadIdx.x + it * NT, r = idx / SLOTS, c = idx % SLOTS, pos = row0 + r;
      if (c < (D >> 2)) {
        const bool ok = pos < n_valid;
        cp_async16(smem_addr(dst + r * ld + c * 4), ok ? base + int64_t(pos) * ss + c * 4 : base, ok);
      }
    }
    return;
  }
  for (int idx = threadIdx.x; idx < ROWS * D; idx += NT) {
    const int r = idx / D, d = idx - r * D, pos = row0 + r;
    float x = 0.f;
    if (pos < n_valid) {
      const float* row = base + pos * ss;
      x = row[d];
      if (rotate && d < 2 * rot.half) {
        const int64_t t = b * rot.sb + int64_t(pos) * D + d;
        const float xp = rot_sign(d, rot) * row[partner(d, rot)];
        x = __fadd_rn(__fmul_rn(x, rot.cos[t]), __fmul_rn(xp, rot.sin[t]));
      }
    }
    dst[r * ld + d] = x;
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kFwdF32Threads, kTf32Blocks<DMAX>) fwd_tf32_kernel(Args a) {
  constexpr int NT = DMAX / 8, MT = kTf32M<DMAX>, BQ = 64 * MT, BKV = kTf32Kv<DMAX>, SJ = BKV / 8;
  constexpr int GS = 4, GP = 4;  // accumulators a group of products covers: of S (kv columns), of O (D columns)
  static_assert(SJ % GS == 0 && NT % GP == 0, "accumulators go GS (GP) at a time");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = a.D, ld = D + 4;
  float* sQ = reinterpret_cast<float*>(smem_raw);   // [BQ][ld]
  float* sK = sQ + BQ * ld;                         // [BKV][ld]
  float* sV = sK + BKV * ld;                        // [BKV][ld]
  int* sq = reinterpret_cast<int*>(sV + BKV * ld);  // [BQ]
  int* skv = sq + BQ;                               // [BKV]
  int* span = skv + BKV;  // [4]: the least and greatest nonzero seg_q of the block, the first and last key holding one
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int n_qt = (a.S + BQ - 1) / BQ;
  const int qt = blockIdx.x % n_qt, h = (blockIdx.x / n_qt) % a.H, b = blockIdx.x / (n_qt * a.H);
  const int hk = h / (a.H / a.Hkv), q0 = qt * BQ;
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const bool rot = a.rot.cos != nullptr, vec = a.vec != 0;
  const int rw = warp * 16 * MT + g;  // this thread's rows of the block: rw + 16 m + 8 hr
  int my_sq[MT][2] = {};              // their segment ids
  int one_seg = 0;                    // the one nonzero segment id of the block's rows (0: none, or several)
  bool kv_same = true;                // this thread's key of the last loaded K tile holds one_seg (or it has none)
  auto load_k = [&](int c) {
    tile_load_f32<kFwdF32Threads, DMAX, BKV>(sK, ld, kb, a.k_ss, c, a.T, D, vec, rot, a.rot, b);
    if (a.seg_kv != nullptr && tid < BKV) {
      const int x = c + tid < a.T ? a.seg_kv[int64_t(b) * a.T + c + tid] : 0;
      skv[tid] = x;
      kv_same = one_seg != 0 && x == one_seg;
    }
  };
  auto load_v = [&](int c) {
    tile_load_f32<kFwdF32Threads, DMAX, BKV>(sV, ld, vb, a.v_ss, c, a.T, D, vec, false, a.rot, b);
  };

  tile_load_f32<kFwdF32Threads, DMAX, BQ>(sQ, ld, qb, a.q_ss, q0, a.S, D, vec, rot, a.rot, b);
  int lo, hi;
  kv_range(a, q0, min(q0 + BQ, a.S) - 1, lo, hi);
  if (a.seg_q != nullptr) {
    // narrow [lo, hi) to the keys whose segment id lies within the block's nonzero ones
    if (tid == 0) span[0] = 0x7fffffff, span[1] = -0x7fffffff - 1, span[2] = 0x7fffffff, span[3] = -1;
    for (int r = tid; r < BQ; r += kFwdF32Threads) sq[r] = q0 + r < a.S ? a.seg_q[int64_t(b) * a.S + q0 + r] : 0;
    __syncthreads();
#pragma unroll
    for (int m = 0; m < MT; ++m) my_sq[m][0] = sq[rw + 16 * m], my_sq[m][1] = sq[rw + 16 * m + 8];
    for (int r = tid; r < BQ; r += kFwdF32Threads)
      if (sq[r] != 0) {
        atomicMin(&span[0], sq[r]);
        atomicMax(&span[1], sq[r]);
      }
    __syncthreads();
    const int smin = span[0], smax = span[1];
    one_seg = smin == smax ? smin : 0;
    int first = 0x7fffffff, last = -1;
    for (int c = lo + tid; c < hi; c += kFwdF32Threads) {
      const int x = a.seg_kv[int64_t(b) * a.T + c];
      if (x != 0 && x >= smin && x <= smax) {
        first = min(first, c);
        last = c;
      }
    }
    if (last >= 0) {
      atomicMin(&span[2], first);
      atomicMax(&span[3], last);
    }
    __syncthreads();
    lo = max(lo, span[2]);
    hi = min(hi, span[3] + 1);
  }
  if (lo < hi) load_k(lo);
  cp_commit();

  float o[MT][NT][4], m_run[MT][2], l[MT][2];
  const float floor_m = -1e20f / a.c;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int n = 0; n < NT; ++n) o[m][n][0] = o[m][n][1] = o[m][n][2] = o[m][n][3] = 0.f;
    m_run[m][0] = m_run[m][1] = floor_m;
    l[m][0] = l[m][1] = 0.f;
  }
  const float* qf = sQ + rw * ld + t4;      // Q[row][t]; + 16 m ld: m tile m; + 8 ld: row + 8; + 4: column + 4
  const float* kf = sK + g * ld + t4;       // K[g][t]
  const float* vf = sV + 2 * t4 * ld + g;   // V[2t][g]; + ld: V[2t + 1][g]
  for (int c0 = lo; c0 < hi; c0 += BKV) {
    cp_wait<0>();
    // K and skv (and Q) landed; every warp is done with V. Whether every key of the tile holds one_seg:
    const bool one_segment = __syncthreads_and(kv_same);
    load_v(c0);
    cp_commit();
    // S = Q K^T
    float s[MT][SJ][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < SJ; ++j) s[m][j][0] = s[m][j][1] = s[m][j][2] = s[m][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DMAX / 8; ++kk) {
      if (kk * 8 >= D) break;
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float* qm = qf + 16 * m * ld + kk * 8;
        split_tf32(qm[0], ab[m][0], as[m][0]);
        split_tf32(qm[8 * ld], ab[m][1], as[m][1]);
        split_tf32(qm[4], ab[m][2], as[m][2]);
        split_tf32(qm[8 * ld + 4], ab[m][3], as[m][3]);
      }
#pragma unroll
      for (int j0 = 0; j0 < SJ; j0 += GS) {
        uint32_t bb[GS][2], bs[GS][2];
#pragma unroll
        for (int i = 0; i < GS; ++i) {
          const float* kr = kf + (j0 + i) * 8 * ld + kk * 8;
          split_tf32(kr[0], bb[i][0], bs[i][0]);
          split_tf32(kr[4], bb[i][1], bs[i][1]);
        }
        mma_3xtf32<MT, SJ, GS>(s, j0, ab, as, bb, bs, GS);
      }
    }
    if (tile_masked(a, q0, c0, BKV, one_segment, BQ)) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < SJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = q0 + rw + 16 * m + (e >> 1) * 8, cl = j * 8 + 2 * t4 + (e & 1);
            if (!valid(a, r, c0 + cl, my_sq[m][e >> 1], a.seg_kv ? skv[cl] : 0)) s[m][j][e] = kNegInf;
          }
    }
    // the online softmax: p in s
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < SJ; ++j) mx = fmaxf(mx, fmaxf(s[m][j][2 * hr], s[m][j][2 * hr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[m][hr], mx);
        const float mc = __fmul_rn(m_new, a.c), alpha = exp2f(__fmul_rn(m_run[m][hr], a.c) - mc);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < SJ; ++j)
#pragma unroll
          for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
            s[m][j][e] = exp2f(__fmul_rn(s[m][j][e], a.c) - mc);
            sum += s[m][j][e];
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[m][hr] = l[m][hr] * alpha + sum;
        m_run[m][hr] = m_new;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          o[m][n][2 * hr] *= alpha;
          o[m][n][2 * hr + 1] *= alpha;
        }
      }
    cp_wait<0>();
    __syncthreads();  // V landed; every warp is done with K and skv
    if (c0 + BKV < hi) load_k(c0 + BKV);
    cp_commit();
    // O += P V: kv columns 8j + 2t, 8j + 2t + 1 of S are the k slots t, t + 4 of step j
#pragma unroll
    for (int j = 0; j < SJ; ++j) {
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        split_tf32(s[m][j][0], ab[m][0], as[m][0]);
        split_tf32(s[m][j][2], ab[m][1], as[m][1]);
        split_tf32(s[m][j][1], ab[m][2], as[m][2]);
        split_tf32(s[m][j][3], ab[m][3], as[m][3]);
      }
      const float* vj = vf + 8 * j * ld;
#pragma unroll
      for (int n0 = 0; n0 < NT; n0 += GP) {
        if (n0 * 8 >= D) break;
        const int live = min(GP, (D >> 3) - n0);
        uint32_t bb[GP][2], bs[GP][2];
#pragma unroll
        for (int i = 0; i < GP; ++i)
          if (i < live) {
            split_tf32(vj[(n0 + i) * 8], bb[i][0], bs[i][0]);
            split_tf32(vj[ld + (n0 + i) * 8], bb[i][1], bs[i][1]);
          }
        mma_3xtf32<MT, NT, GP>(o, n0, ab, as, bb, bs, live);
      }
    }
  }
  cp_wait<0>();  // no copy is in flight at exit (a block with no live kv tile)
  // O = acc / l, LSE = m c + log2(l); O = 0 and LSE = -1e30 on dead rows: l == 0, or segment id 0 (no key is
  // valid; a one-segment tile left such rows unmasked)
  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = q0 + rw + 16 * m + hr * 8;
      if (r >= a.S) continue;
      const float lr = l[m][hr];
      const bool dead = lr == 0.f || (a.seg_q != nullptr && my_sq[m][hr] == 0);
      float* row = out + ((int64_t(b) * a.S + r) * a.H + h) * D + 2 * t4;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        if (n * 8 < D)
          *reinterpret_cast<float2*>(row + n * 8) =
              dead ? make_float2(0.f, 0.f) : make_float2(o[m][n][2 * hr] / lr, o[m][n][2 * hr + 1] / lr);
      if (t4 == 0)
        a.lse[(int64_t(b) * a.H + h) * a.S + r] = dead ? kNegInf : __fmul_rn(m_run[m][hr], a.c) + log2f(lr);
    }
}

// ---- the backward: dq (and delta), dk and dv -------------------------------------
//
// dq_tf32_kernel<DMAX> and dkv_tf32_kernel<DMAX> take the inputs of
// flash_tf32_dq and flash_tf32_dkv. They replace, for them, _bwd_dq_kernel
// (contrastors_tpu/ops/flash_attention.py:422, call :640) and _bwd_dkv_kernel
// (:512, call :700), with fused_rot (_rot_block :76, adjoint _rot_adjoint
// :87); dq writes delta = rowsum(dO * O) for dk/dv, so it launches first.
//
// What bounds them on an H100: the products, at 3xTF32's rate (this file's
// note): 3 and 4 products of S T D each per (batch, head). A first design
// ran them as fp32 FMAs over tiles in shared memory, each thread reading two
// operands for every FMA, nothing in flight under the products, p and ds
// through shared memory between them: 1.49x (dq) and 1.67x (dk/dv) SDPA's
// whole backward at the fp32 document chunk.
//
// What the design does about it. The two kernels are one loop with the roles
// swapped: a block holds a fixed side (dq: Q and dO, its query rows; dk/dv: K
// and V, its kv rows) and walks the other side's tiles of 32 rows (dq: K and
// V over the kv range; dk/dv: Q and dO over the query range of every q head
// of the group, their LSE and delta read once a tile);
//   - each of 4 warps owns 16 fixed rows. X W^T (dq: S = Q K^T, dP = dO V^T;
//     dk/dv: S^T = K Q^T, dP^T = V dO^T) takes the fixed rows as A fragments
//     (split once for the 4 n tiles of the walked tile) and the walked rows
//     as B fragments, read as the forward reads K; p and ds are computed in
//     those accumulators and feed C W (dq: dQ += dS K; dk/dv: dV += P^T dO,
//     dK += dS^T Q) as A fragments, split once for all n tiles, with the
//     walked tile as B read as the forward reads V. No p or ds tile goes
//     through shared memory;
//   - the splits, more than the products, take the time, so they take 3
//     instructions (split_tf32_fast), and the k loop of X W^T runs in passes
//     of 64 columns (one at DMAX 64; at 128 and 256 a loop, which left the
//     registers without spills and ran faster than the whole loop unrolled);
//   - the walked side is double-buffered at DMAX 64, where two stages fit
//     beside three blocks a SM: the next tile's copies run under all of this
//     tile's products. Above, one buffer an operand, and each copy runs under
//     the products that do not read it (dq: V's under S and dQ, K's under dP;
//     dk/dv: Q's under dV, dO's under S^T);
//   - registers: dq holds dQ (16 x DMAX a warp), S and dP (16 x 32); dk/dv
//     holds dK and dV (16 x DC a warp) and S^T and dP^T (16 x 32). At DMAX
//     256, dK and dV would take 256 registers a thread: 8 warps, warp (w % 4,
//     w / 4) owning kv rows 16 (w % 4) .. and the D columns 128 (w / 4) ..,
//     each pair computing the same S^T and dP^T;
//   - dead tiles are skipped: the walk covers kv_range / q_range narrowed
//     to the positions whose segment id lies within the block's nonzero ids
//     (p = 0 outside, so no output changes); a tile is masked element by
//     element only where a mask can cut it (tile_masked), a tile whose
//     walked positions all hold the block's one nonzero segment id not at all
//     (fixed rows of id 0 are set empty instead);
//   - the rotary adjoint runs on the fp32 dq / dk through shared memory
//     (store_adjoint). An empty row's p is 0, so its dq (dk, dv) is 0.
// Slower at the fp32 document chunk on an H100 (tools/generic_kernel_probe.py
// in turns): 32 rows a dq warp (two m tiles sharing each B split, two blocks
// a SM), 32 kv rows a dk/dv warp, 64-row walked tiles, 16-row ones with four
// dq blocks a SM, one dq stage with four blocks, the two X W^T (and dV, dK)
// interleaved in one loop, and walked tiles split once on arrival into big
// and small planes (two blocks a SM, twice the shared-memory reads).

constexpr int kBwdF32Threads = 128;  // 4 warps (dk/dv: 4 for each column group)
constexpr int kBwdF32Rows = 64;      // fixed rows of a block: 16 a warp
constexpr int kBwdF32Walk = 32;      // rows of a walked tile
template <int DMAX>
constexpr int kBwdF32Stages = DMAX > 64 ? 1 : 2;  // walked-tile stages
template <int DMAX>
constexpr int kBwdF32Blocks = DMAX > 128 ? 1 : (DMAX > 64 ? 2 : 3);  // blocks a SM the registers must allow
template <int DMAX>
constexpr int kDkvF32Groups = DMAX > 128 ? 2 : 1;  // dk/dv's column groups: warps (w % 4, w / 4)

// shared memory of a backward block: the fixed side's two tiles of `fixed`
// rows, the walked side's two of `walked` rows (all stages), `stats` floats of
// LSE / delta and the ids of both sides
size_t bwd_tf32_bytes(int D, int fixed, int walked, int stats) {
  return size_t(2 * fixed + 2 * walked) * (D + 4) * sizeof(float) + stats * sizeof(float) +
         (fixed + walked + 4) * sizeof(int);
}

// acc[m][j] = X W^T over D columns: X the warp's MT m tiles (xf: the thread's
// row g, column t), W SJ 8-row n tiles of the walked tile (wf: its row g,
// column t); X's fragments split once for the SJ n tiles, W's once for the MT
// m tiles
template <int MT, int SJ, int DMAX>
__device__ __forceinline__ void product_nt(float (&acc)[MT][SJ][4], const float* xf, const float* wf, int ld,
                                           int D) {
  constexpr int GS = SJ < 4 ? SJ : 4;
  static_assert(SJ % GS == 0, "n tiles go GS at a time");
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < SJ; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
  constexpr int KU = DMAX / 8 < 8 ? DMAX / 8 : 8;  // k steps of one pass: 64 columns
#pragma unroll 1
  for (int k0 = 0; k0 < DMAX / 8; k0 += KU)
#pragma unroll
  for (int kk = k0; kk < k0 + KU; ++kk) {
    if (kk * 8 >= D) break;
    uint32_t ab[MT][4], as[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) a_frag(xf + 16 * m * ld + kk * 8, ld, ab[m], as[m]);
#pragma unroll
    for (int j0 = 0; j0 < SJ; j0 += GS) {
      uint32_t bb[GS][2], bs[GS][2];
#pragma unroll
      for (int i = 0; i < GS; ++i) {
        const float* wr = wf + (j0 + i) * 8 * ld + kk * 8;
        split_tf32_fast(wr[0], bb[i][0], bs[i][0]);
        split_tf32_fast(wr[4], bb[i][1], bs[i][1]);
      }
      mma_3xtf32<MT, SJ, GS>(acc, j0, ab, as, bb, bs, GS);
    }
  }
}

// Narrows the walked range [lo, hi) to the positions whose segment id (in
// walked_ids) lies within the nonzero ids of the fixed rows (ids[0 .. rows),
// in shared memory, 0 past the sequence), and returns the one nonzero id of
// the fixed rows (0: none, or several). Every thread of the block calls it;
// it ends on a barrier, so ids may be read after it.
template <int NT>
__device__ int narrow_to_segments(const int* ids, int rows, const int* walked_ids, int& lo, int& hi, int* span) {
  if (threadIdx.x == 0) span[0] = 0x7fffffff, span[1] = -0x7fffffff - 1, span[2] = 0x7fffffff, span[3] = -1;
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += NT)
    if (ids[r] != 0) {
      atomicMin(&span[0], ids[r]);
      atomicMax(&span[1], ids[r]);
    }
  __syncthreads();
  const int smin = span[0], smax = span[1];
  int first = 0x7fffffff, last = -1;
  for (int c = lo + threadIdx.x; c < hi; c += NT) {
    const int x = walked_ids[c];
    if (x != 0 && x >= smin && x <= smax) {
      first = min(first, c);
      last = c;
    }
  }
  if (last >= 0) {
    atomicMin(&span[2], first);
    atomicMax(&span[3], last);
  }
  __syncthreads();
  lo = max(lo, span[2]);
  hi = min(hi, span[3] + 1);
  return smin == smax ? smin : 0;
}

template <int DMAX>
__global__ void __launch_bounds__(kBwdF32Threads, kBwdF32Blocks<DMAX>) dq_tf32_kernel(Args a) {
  constexpr int NT = DMAX / 8, MT = 1, BQ = kBwdF32Rows, BKV = kBwdF32Walk, SJ = BKV / 8, ST = kBwdF32Stages<DMAX>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = a.D, ld = D + 4;
  float* sQ = reinterpret_cast<float*>(smem_raw);   // [BQ][ld]; after the walk, dq [BQ][D + 1] (rotary)
  float* sdO = sQ + BQ * ld;                        // [BQ][ld]
  float* sK = sdO + BQ * ld;                        // [ST][BKV][ld]
  float* sV = sK + ST * BKV * ld;                   // [ST][BKV][ld]
  float* sdelta = sV + ST * BKV * ld;               // [BQ]
  int* sq = reinterpret_cast<int*>(sdelta + BQ);    // [BQ]
  int* skv = sq + BQ;                               // [ST][BKV]
  int* span = skv + ST * BKV;                       // [4]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int n_qt = (a.S + BQ - 1) / BQ;
  const int qt = blockIdx.x % n_qt, h = (blockIdx.x / n_qt) % a.H, b = blockIdx.x / (n_qt * a.H);
  const int hk = h / (a.H / a.Hkv), q0 = qt * BQ;
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* ob = static_cast<const float*>(a.o) + b * a.o_sb + h * a.o_sh;
  const float* dob = static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const bool rot = a.rot.cos != nullptr, vec = a.vec != 0;
  const int64_t stat0 = (int64_t(b) * a.H + h) * a.S;
  const int rw = warp * 16 * MT + g;  // this thread's rows of the block: rw + 16 m + 8 hr
  int my_sq[MT][2] = {};              // their segment ids
  int one_seg = 0;                    // the one nonzero segment id of the block's rows (0: none, or several)
  int same = (1 << ST) - 1;           // bit st: this thread's key of stage st's K tile holds one_seg (or it has none)
  auto load_k = [&](int c, int st) {
    tile_load_f32<kBwdF32Threads, DMAX, BKV>(sK + st * BKV * ld, ld, kb, a.k_ss, c, a.T, D, vec, rot, a.rot, b);
    if (a.seg_kv != nullptr && tid < BKV) {
      const int x = c + tid < a.T ? a.seg_kv[int64_t(b) * a.T + c + tid] : 0;
      skv[st * BKV + tid] = x;
      same = (same & ~(1 << st)) | (int(one_seg != 0 && x == one_seg) << st);
    }
  };
  auto load_v = [&](int c, int st) {
    tile_load_f32<kBwdF32Threads, DMAX, BKV>(sV + st * BKV * ld, ld, vb, a.v_ss, c, a.T, D, vec, false, a.rot, b);
  };

  tile_load_f32<kBwdF32Threads, DMAX, BQ>(sQ, ld, qb, a.q_ss, q0, a.S, D, vec, rot, a.rot, b);
  tile_load_f32<kBwdF32Threads, DMAX, BQ>(sdO, ld, dob, a.do_ss, q0, a.S, D, vec, false, a.rot, b);
  cp_commit();
  int lo, hi;
  kv_range(a, q0, min(q0 + BQ, a.S) - 1, lo, hi);
  if (a.seg_q != nullptr) {
    for (int r = tid; r < BQ; r += kBwdF32Threads) sq[r] = q0 + r < a.S ? a.seg_q[int64_t(b) * a.S + q0 + r] : 0;
    one_seg = narrow_to_segments<kBwdF32Threads>(sq, BQ, a.seg_kv + int64_t(b) * a.T, lo, hi, span);
#pragma unroll
    for (int m = 0; m < MT; ++m) my_sq[m][0] = sq[rw + 16 * m], my_sq[m][1] = sq[rw + 16 * m + 8];
  }
  if (lo < hi) load_v(lo, 0);
  cp_commit();
  if (lo < hi) load_k(lo, 0);
  cp_commit();
  cp_wait<2>();
  __syncthreads();  // Q and dO landed
  // delta = rowsum(dO * O) of the warp's own rows, a lane for every 32nd column
#pragma unroll
  for (int i = 0; i < 16 * MT; ++i) {
    const int rl = warp * 16 * MT + i, r = q0 + rl;
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < DMAX / 32; ++k) {
      const int d = lane + 32 * k;
      if (r < a.S && d < D) part += sdO[rl * ld + d] * ob[int64_t(r) * a.o_ss + d];
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) {
      sdelta[rl] = part;
      if (r < a.S) a.delta[stat0 + r] = part;
    }
  }
  __syncwarp();
  float lse[MT][2], dl[MT][2];  // an empty row (past S, or of segment id 0) takes LSE -1e30: its p is 0
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int rl = rw + 16 * m + 8 * hr, r = q0 + rl;
      const bool live = r < a.S && (a.seg_q == nullptr || my_sq[m][hr] != 0);
      lse[m][hr] = live ? a.lse[stat0 + r] : kNegInf;
      dl[m][hr] = sdelta[rl];
    }
  float dq[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) dq[m][n][0] = dq[m][n][1] = dq[m][n][2] = dq[m][n][3] = 0.f;
  const float* qf = sQ + rw * ld + t4;   // Q[row][t]
  const float* dof = sdO + rw * ld + t4;

  // s (S of the kv tile at c0, in stage st) becomes ds = ((dp - delta) * p) * scale
  auto to_ds = [&](float(&s)[MT][SJ][4], const float(&dp)[MT][SJ][4], int c0, int st, bool one_segment) {
    const bool masked = tile_masked(a, q0, c0, BKV, one_segment, BQ);
    const int* skv_t = skv + st * BKV;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < SJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1, cl = 8 * j + 2 * t4 + (e & 1);
          const bool ok = lse[m][hr] > kNegInf / 2 &&
                          (!masked || valid(a, q0 + rw + 16 * m + 8 * hr, c0 + cl, my_sq[m][hr],
                                            a.seg_kv ? skv_t[cl] : 0));
          const float p = ok ? exp2f(__fmul_rn(s[m][j][e], a.c) - lse[m][hr]) : 0.f;
          s[m][j][e] = __fmul_rn(__fmul_rn(dp[m][j][e] - dl[m][hr], p), a.scale);
        }
  };

  if constexpr (ST == 2) {
    for (int c0 = lo, st = 0; c0 < hi; c0 += BKV, st ^= 1) {
      if (c0 + BKV < hi) {
        __syncthreads();  // every warp is done with stage st ^ 1
        load_v(c0 + BKV, st ^ 1);
        load_k(c0 + BKV, st ^ 1);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      const bool one_segment = __syncthreads_and((same >> st) & 1);  // stage st landed
      float s[MT][SJ][4], dp[MT][SJ][4];
      product_nt<MT, SJ, DMAX>(dp, dof, sV + (st * BKV + g) * ld + t4, ld, D);
      product_nt<MT, SJ, DMAX>(s, qf, sK + (st * BKV + g) * ld + t4, ld, D);
      to_ds(s, dp, c0, st, one_segment);
      product_cw<MT, SJ, NT>(dq, s, sK + (st * BKV + 2 * t4) * ld + g, ld, D);
    }
  } else {
    for (int c0 = lo; c0 < hi; c0 += BKV) {
      const bool next = c0 + BKV < hi;
      float s[MT][SJ][4], dp[MT][SJ][4];
      cp_wait<1>();
      __syncthreads();  // V landed
      product_nt<MT, SJ, DMAX>(dp, dof, sV + g * ld + t4, ld, D);
      __syncthreads();  // every warp is done with V
      if (next) load_v(c0 + BKV, 0);
      cp_commit();
      cp_wait<1>();
      const bool one_segment = __syncthreads_and(same & 1);  // K landed
      product_nt<MT, SJ, DMAX>(s, qf, sK + g * ld + t4, ld, D);
      to_ds(s, dp, c0, 0, one_segment);
      product_cw<MT, SJ, NT>(dq, s, sK + 2 * t4 * ld + g, ld, D);
      __syncthreads();  // every warp is done with K and skv
      if (next) load_k(c0 + BKV, 0);
      cp_commit();
    }
  }
  cp_wait<0>();  // no copy is in flight at exit (a block with no live kv tile)
  float* out = static_cast<float*>(a.dq) + (int64_t(b) * a.S * a.H + h) * D;
  const int64_t row_stride = int64_t(a.H) * D;
  if (rot) {
    __syncthreads();  // every warp is done with Q and dO: dq goes through them for the adjoint
    float* dq32 = sQ;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int rl = rw + 16 * m + 8 * hr;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int d = n * 8 + 2 * t4;
          if (d < D) {
            dq32[rl * (D + 1) + d] = dq[m][n][2 * hr];
            dq32[rl * (D + 1) + d + 1] = dq[m][n][2 * hr + 1];
          }
        }
      }
    __syncthreads();
    store_adjoint<float, kBwdF32Threads>(out, row_stride, dq32, q0, BQ, a.S, D, a.rot, b);
    return;
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = q0 + rw + 16 * m + 8 * hr;
      if (r >= a.S) continue;
      float* row = out + r * row_stride + 2 * t4;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        if (n * 8 < D) *reinterpret_cast<float2*>(row + n * 8) = make_float2(dq[m][n][2 * hr], dq[m][n][2 * hr + 1]);
    }
}

template <int DMAX>
__global__ void __launch_bounds__(kBwdF32Threads * kDkvF32Groups<DMAX>, kBwdF32Blocks<DMAX>) dkv_tf32_kernel(Args a) {
  constexpr int CW = kDkvF32Groups<DMAX>, NTH = kBwdF32Threads * CW, DC = DMAX / CW, NC = DC / 8;
  constexpr int MT = 1, BK = kBwdF32Rows, BQ = kBwdF32Walk, SJ = BQ / 8, ST = kBwdF32Stages<DMAX>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = a.D, ld = D + 4;
  float* sK = reinterpret_cast<float*>(smem_raw);      // [BK][ld]; after the walk, dk [BK][D + 1] (rotary)
  float* sV = sK + BK * ld;                            // [BK][ld]
  float* sQ = sV + BK * ld;                            // [ST][BQ][ld]
  float* sdO = sQ + ST * BQ * ld;                      // [ST][BQ][ld]
  float* slse = sdO + ST * BQ * ld;                    // [ST][BQ]
  float* sdelta = slse + ST * BQ;                      // [ST][BQ]
  int* skv = reinterpret_cast<int*>(sdelta + ST * BQ);  // [BK]
  int* sq = skv + BK;                                  // [ST][BQ]
  int* span = sq + ST * BQ;                            // [4]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int n_kt = (a.T + BK - 1) / BK;
  const int kt = blockIdx.x % n_kt, hk = (blockIdx.x / n_kt) % a.Hkv, b = blockIdx.x / (n_kt * a.Hkv);
  const int gq = a.H / a.Hkv, c0 = kt * BK;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const bool rot = a.rot.cos != nullptr, vec = a.vec != 0;
  const int rw = (warp & 3) * 16 * MT + g;  // this thread's kv rows of the block: rw + 16 m + 8 hr
  const int dc0 = (warp >> 2) * DC, cols = min(DC, D - dc0);  // the warp's D columns: dc0 .. dc0 + cols
  int my_skv[MT][2] = {};  // the segment ids of the thread's kv rows
  int one_seg = 0;         // the one nonzero segment id of the block's kv rows (0: none, or several)
  int same = (1 << ST) - 1;  // bit st: this thread's query row of stage st's tile holds one_seg (or is past S)

  tile_load_f32<NTH, DMAX, BK>(sK, ld, kb, a.k_ss, c0, a.T, D, vec, rot, a.rot, b);
  tile_load_f32<NTH, DMAX, BK>(sV, ld, vb, a.v_ss, c0, a.T, D, vec, false, a.rot, b);
  cp_commit();
  int lo, hi;
  q_range(a, c0, min(c0 + BK, a.T) - 1, lo, hi);
  if (a.seg_q != nullptr) {
    for (int r = tid; r < BK; r += NTH) skv[r] = c0 + r < a.T ? a.seg_kv[int64_t(b) * a.T + c0 + r] : 0;
    one_seg = narrow_to_segments<NTH>(skv, BK, a.seg_q + int64_t(b) * a.S, lo, hi, span);
#pragma unroll
    for (int m = 0; m < MT; ++m) my_skv[m][0] = skv[rw + 16 * m], my_skv[m][1] = skv[rw + 16 * m + 8];
  }
  const int n_rt = hi > lo ? (hi - lo + BQ - 1) / BQ : 0, items = gq * n_rt;
  // item i: q head hk * gq + i / n_rt, query rows lo + (i % n_rt) * BQ ..
  auto issue_q = [&](int i, int st) {  // Q, with the tile's LSE, delta and segment ids
    const int h = hk * gq + i / n_rt, r0 = lo + (i % n_rt) * BQ;
    const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
    tile_load_f32<NTH, DMAX, BQ>(sQ + st * BQ * ld, ld, qb, a.q_ss, r0, a.S, D, vec, rot, a.rot, b);
    if (tid < BQ) {
      const int r = r0 + tid;
      const int64_t stat = (int64_t(b) * a.H + h) * a.S + r;
      slse[st * BQ + tid] = r < a.S ? a.lse[stat] : kNegInf;
      sdelta[st * BQ + tid] = r < a.S ? a.delta[stat] : 0.f;
      if (a.seg_q != nullptr) {
        const int x = r < a.S ? a.seg_q[int64_t(b) * a.S + r] : 0;
        sq[st * BQ + tid] = x;
        same = (same & ~(1 << st)) | (int(r >= a.S || (one_seg != 0 && x == one_seg)) << st);
      }
    }
  };
  auto issue_do = [&](int i, int st) {
    const int h = hk * gq + i / n_rt, r0 = lo + (i % n_rt) * BQ;
    const float* dob = static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh;
    tile_load_f32<NTH, DMAX, BQ>(sdO + st * BQ * ld, ld, dob, a.do_ss, r0, a.S, D, vec, false, a.rot, b);
  };

  float dk[MT][NC][4], dv[MT][NC][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[m][n][e] = dv[m][n][e] = 0.f;
  const float* kf = sK + rw * ld + t4;  // K[row][t]
  const float* vf = sV + rw * ld + t4;

  // s (S^T of item it, in stage st) becomes p, dp (dP^T) ds = ((dp - delta) * p) * scale
  auto to_p_ds = [&](float(&s)[MT][SJ][4], float(&dp)[MT][SJ][4], int it, int st, bool one_segment) {
    const int r0 = lo + (it % n_rt) * BQ;
    const bool masked = tile_masked(a, r0, c0, BK, one_segment, BQ);
    float lse[SJ][2], delta[SJ][2];  // of the thread's query columns 8 j + 2 t + e
#pragma unroll
    for (int j = 0; j < SJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        lse[j][e] = slse[st * BQ + 8 * j + 2 * t4 + e];
        delta[j][e] = sdelta[st * BQ + 8 * j + 2 * t4 + e];
      }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < SJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1, ql = 8 * j + 2 * t4 + (e & 1);
          const float l = lse[j][e & 1];
          const bool ok = (a.seg_q == nullptr || my_skv[m][hr] != 0) && l > kNegInf / 2 &&
                          (!masked || valid(a, r0 + ql, c0 + rw + 16 * m + 8 * hr, a.seg_q ? sq[st * BQ + ql] : 0,
                                            my_skv[m][hr]));
          const float p = ok ? exp2f(__fmul_rn(s[m][j][e], a.c) - l) : 0.f;
          s[m][j][e] = p;
          dp[m][j][e] = __fmul_rn(__fmul_rn(dp[m][j][e] - delta[j][e & 1], p), a.scale);
        }
  };

  if constexpr (ST == 2) {
    if (items > 0) {
      issue_q(0, 0);
      issue_do(0, 0);
    }
    cp_commit();
    for (int it = 0; it < items; ++it) {
      const int st = it & 1;
      if (it + 1 < items) {
        __syncthreads();  // every warp is done with stage st ^ 1 (item it - 1)
        issue_q(it + 1, st ^ 1);
        issue_do(it + 1, st ^ 1);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      const bool one_segment = __syncthreads_and((same >> st) & 1);  // item it (and K, V) landed
      float s[MT][SJ][4], dp[MT][SJ][4];
      product_nt<MT, SJ, DMAX>(s, kf, sQ + (st * BQ + g) * ld + t4, ld, D);
      product_nt<MT, SJ, DMAX>(dp, vf, sdO + (st * BQ + g) * ld + t4, ld, D);
      to_p_ds(s, dp, it, st, one_segment);
      product_cw<MT, SJ, NC>(dv, s, sdO + (st * BQ + 2 * t4) * ld + g + dc0, ld, cols);
      product_cw<MT, SJ, NC>(dk, dp, sQ + (st * BQ + 2 * t4) * ld + g + dc0, ld, cols);
    }
  } else {
    if (items > 0) issue_q(0, 0);
    cp_commit();
    if (items > 0) issue_do(0, 0);
    cp_commit();
    for (int it = 0; it < items; ++it) {
      const bool next = it + 1 < items;
      float s[MT][SJ][4], dp[MT][SJ][4];
      cp_wait<1>();
      const bool one_segment = __syncthreads_and(same & 1);  // Q and its statistics (and K, V) landed
      product_nt<MT, SJ, DMAX>(s, kf, sQ + g * ld + t4, ld, D);
      cp_wait<0>();
      __syncthreads();  // dO landed
      product_nt<MT, SJ, DMAX>(dp, vf, sdO + g * ld + t4, ld, D);
      to_p_ds(s, dp, it, 0, one_segment);
      product_cw<MT, SJ, NC>(dk, dp, sQ + 2 * t4 * ld + g + dc0, ld, cols);
      __syncthreads();  // every warp is done with Q and the tile's statistics
      if (next) issue_q(it + 1, 0);
      cp_commit();
      product_cw<MT, SJ, NC>(dv, s, sdO + 2 * t4 * ld + g + dc0, ld, cols);
      __syncthreads();  // every warp is done with dO
      if (next) issue_do(it + 1, 0);
      cp_commit();
    }
  }
  cp_wait<0>();  // K and V, where no item waited for them
  const int64_t row_stride = int64_t(a.Hkv) * D;
  const int64_t base = (int64_t(b) * a.T * a.Hkv + hk) * D;
  float* dk_out = static_cast<float*>(a.dk) + base;
  float* dv_out = static_cast<float*>(a.dv) + base;
  float* dk32 = sK;          // dk for the adjoint
  if (rot) __syncthreads();  // every warp is done with K and V
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int cl = rw + 16 * m + 8 * hr, c = c0 + cl;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int d = dc0 + n * 8 + 2 * t4;
        if (n * 8 >= cols) break;
        if (c < a.T) {
          *reinterpret_cast<float2*>(dv_out + c * row_stride + d) = make_float2(dv[m][n][2 * hr], dv[m][n][2 * hr + 1]);
          if (!rot)
            *reinterpret_cast<float2*>(dk_out + c * row_stride + d) =
                make_float2(dk[m][n][2 * hr], dk[m][n][2 * hr + 1]);
        }
        if (rot) {
          dk32[cl * (D + 1) + d] = dk[m][n][2 * hr];
          dk32[cl * (D + 1) + d + 1] = dk[m][n][2 * hr + 1];
        }
      }
    }
  if (rot) {
    __syncthreads();
    store_adjoint<float, NTH>(dk_out, row_stride, dk32, c0, BK, a.T, D, a.rot, b);
  }
}

// ---- launches ------------------------------------------------------------------

template <int DMAX>
cudaError_t run_fwd_tf32(const Args& a, cudaStream_t s) {
  constexpr int BQ = 64 * kTf32M<DMAX>;
  return launch(fwd_tf32_kernel<DMAX>, fwd_tf32_bytes(a.D, BQ, kTf32Kv<DMAX>), (a.S + BQ - 1) / BQ * a.H * a.B,
                kFwdF32Threads, a, s);
}

template <int DMAX>
cudaError_t run_bwd_tf32(int which, const Args& a, cudaStream_t s) {
  constexpr int R = kBwdF32Rows, W = kBwdF32Stages<DMAX> * kBwdF32Walk;
  if (which == 1)
    return launch(dq_tf32_kernel<DMAX>, bwd_tf32_bytes(a.D, R, W, R), (a.S + R - 1) / R * a.H * a.B, kBwdF32Threads,
                  a, s);
  return launch(dkv_tf32_kernel<DMAX>, bwd_tf32_bytes(a.D, R, W, 2 * W), (a.T + R - 1) / R * a.Hkv * a.B,
                kBwdF32Threads * kDkvF32Groups<DMAX>, a, s);
}

int dispatch(int which, Args& a, int window, const void* rot_cos, const void* rot_sin, int64_t rot_sb, int rot_half,
             int rot_interleaved, void* stream) {
  bool empty = false;
  const cudaError_t e = prepare(4, which, a, window, rot_cos, rot_sin, rot_sb, rot_half, rot_interleaved, empty, 256);
  if (e != cudaSuccess || empty) return int(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (which == 0) {
    if (a.D <= 64) return int(run_fwd_tf32<64>(a, s));
    if (a.D <= 128) return int(run_fwd_tf32<128>(a, s));
    return int(run_fwd_tf32<256>(a, s));
  }
  if (a.D <= 64) return int(run_bwd_tf32<64>(which, a, s));
  if (a.D <= 128) return int(run_bwd_tf32<128>(which, a, s));
  return int(run_bwd_tf32<256>(which, a, s));
}

}  // namespace

// fp32 q/k/v/O/dO/dq/dk/dv (the argument lists: flash_generic_common.cuh)
extern "C" int flash_tf32_fwd(FLASH_FWD_PARAMS) {
  FLASH_FWD_ARGS(a);
  return dispatch(0, a, window, rot_cos, rot_sin, rot_sb, rot_half, rot_interleaved, stream);
}

extern "C" int flash_tf32_dq(FLASH_DQ_PARAMS) {
  FLASH_DQ_ARGS(a);
  return dispatch(1, a, window, rot_cos, rot_sin, rot_sb, rot_half, rot_interleaved, stream);
}

extern "C" int flash_tf32_dkv(FLASH_DKV_PARAMS) {
  FLASH_DKV_ARGS(a);
  return dispatch(2, a, window, rot_cos, rot_sin, rot_sb, rot_half, rot_interleaved, stream);
}
