// Flash-attention backward for Hopper (sm_90a): bf16 q/k/v/O/dO/dq/dk/dv,
// fp32 LSE and delta.
//
// Replaces the two Pallas TPU backward kernels of
// contrastors_tpu/ops/flash_attention.py, both launched by _bwd (:608):
//   _bwd_dq_kernel  (:422, call :640) -> flash_bwd_dq_kernel<D, false>,
//   _bwd_dkv_kernel (:512, call :700) -> flash_bwd_dkv_kernel<D, false>,
// and their fused_rot=True forms (:426-446, :516-545; adjoint :502-509,
// :600-604) -> the same kernels with kRot = true.
// On the TPU each kernel carries its accumulator in VMEM scratch across the
// sequential innermost grid axis. Here a block owns an output tile (an
// "item") and walks that axis as a loop, with the accumulator in fp32
// registers:
//   dq:  an item is a tile of q rows of one (batch, head); the walk runs
//        over 64-row kv tiles;
//   dkv: an item is a tile of kv rows of one (batch, kv head); the walk runs
//        over the GQA group's q heads x 64-row q tiles.
// Every output tile has one owner and sums in a fixed order: no atomics, and
// two runs on the same inputs are bit-identical. p is recomputed from the
// forward's base-2 LSE, so the dq kernel runs three products (s = q k^T,
// dp = dO v^T, dq += ds k) and the dkv kernel four (s^T, dp^T, dv += p^T dO,
// dk += ds^T q).
//
// What bounds them on an H100: each product is 2*D FLOP per live (row, col)
// pair, against q, k, v, O, dO read once and dq (dk, dv) written once: 3*S/4
// (dq) or S (dkv) FLOP per byte at S = T, D = 64. Bytes bound the short
// training shapes (S = 32, 256), the tensor cores the MLM shape (S = 2048).
// Only wgmma reaches the tensor cores' full rate, and only when its
// operands are in shared memory ahead of it. The design:
//   - Warp-specialised blocks: a producer warpgroup (one warp loads; with
//     rotary the other three rotate) and kC consumer warpgroups, each
//     consumer owning 64 rows of the item. kC = 2 (128-row items, one block
//     per SM) at D = 64; kC = 1 at D = 128, where dk and dv alone hold 128
//     fp32 accumulators a thread, and at D = 64 where the item's rows (S for
//     dq, T for dk/dv) are at most 64: then two one-warpgroup blocks share
//     an SM and each streams its own items. At D = 64 `setmaxnreg` moves
//     registers from the producer (56 a thread) to the consumers (224 with
//     two, 200 with one), above the launch's 168 / 128: dk/dv needs them,
//     and spilled at 168. The item's fixed operands (dq: q and
//     dO; dkv: k and v) are one TMA load into one of two item slots; the
//     walked operands (dq: k and v; dkv: q and dO) go through a ring of
//     64-row stages, each filled by TMA (cp.async.bulk.tensor, 128-byte
//     swizzle, 4-D tensor maps over the [B, S, H, D] storage and its
//     strides, a row of D = 128 being two 64-wide boxes) behind a full and
//     an empty mbarrier; with NeoX rotary, the rows' table entries come in
//     the same stage by TMA. The producer's lanes read the stage's per-row
//     values (dq: the kv tile's segment ids; dkv: the q tile's -LSE, delta
//     and segment ids) before waiting for the stage, write them and the
//     segment id the whole tile shares (or -1), and arrive on its full
//     barrier. Every consumer warp releases the stage when done with it.
//   - Products: s and dp by wgmma m64n64k16 from shared memory, both
//     operands K-major; p and ds in fp32 registers, cast to bf16 in the
//     registers as wgmma's A operand (the accumulator layout of one 16-deep
//     step is the A layout), so dq += ds k, dv += p^T dO and dk += ds^T q
//     read only their B operand from shared memory, MN-major through the
//     transpose bit: no copies.
//   - Persistent: the grid is as many blocks as fit on the SMs, each walking
//     items (row tiles of each (batch, head), adjacent tiles of one head
//     together), so the producer loads the next item's tiles while this one
//     computes; at S = T = 32 264 blocks stream ~23 items each instead of
//     6144 blocks running once. A consumer whose rows lie past S (T)
//     computes on zero rows.
//   - Delta = rowsum(dO * O) is computed by the dq kernel from O and dO, per
//     row, and written to a [B, H, S] fp32 buffer that the dkv kernel,
//     launched after it on the same stream, reads. Every row gets its delta,
//     also where no kv tile is live.
//   - Dead tiles under causal or window masking are skipped, as the JAX
//     kernels skip them. A warp whose rows all share the tile's one segment
//     (an unmasked or all-ones mask, a whole tile), with no band, takes a
//     branch-free softmax; the others check every (row, col) pair.
// The pipeline (the configuration, the slots and stages, the producer's
// steps, the wgmma wrappers, the kv walk, the rotation of swizzled tiles,
// the tensor maps and the launch) is flash_common.cuh's, shared with the
// forward (flash_fwd.cu), which is dq's kernel with an online softmax.
// Dynamic shared memory per block (Cfg::kSmemBytes): 132 KiB (plain) / 196
// KiB (rotary) with two warpgroups, 67 / 99 KiB with one at D = 64; 163 /
// 195 KiB at D = 128.
//
// Fused rotary (kRot; the tables are fp32 rows of D columns, duplicated
// halves for NeoX, repeated pairs for GPT-J, identity rows past rot_dim and
// past S): the fixed operand (dq: q, dkv: k) is rotated once per item from
// the tables in device memory, by the consumers, before a proxy fence and a
// barrier (wgmma reads shared memory through the async proxy); the walked
// one (dq: k, dkv: q) once per stage, off the consumers' path, by the
// producer warpgroup's three other warps: they wait for the stage's bytes
// (its raw barrier), rotate it in shared memory, NeoX from the entries TMA
// staged beside it (one per rotated pair: a quarter of the table bytes that
// rotating each element from both tables reads), GPT-J from the tables in
// device memory, fence, and arrive on its full barrier.
// Products and the sum are rounded apart, then cast once: bit-identical to
// the plain version's rotated bf16 operand. dq (dk) is accumulated with
// respect to the rotated operand in fp32, and the rotation's adjoint
// g*cos + rot^T(g*sin) is applied to the fp32 accumulator before the single
// bf16 cast (the partner column of every accumulator element lives in the
// same thread).
//
// Semantics follow JAX _bwd: s = q.k^T * c (c = softmax_scale*log2(e)) with
// the forward's masks; p = exp2(s - lse), and p = 0 on rows whose LSE is
// -1e30 (fully masked rows have O = 0 and dq = 0); dp = dO.v^T;
// ds = p * (dp - delta) * softmax_scale; dq = bf16(ds) k, dk = bf16(ds)^T q,
// dv = bf16(p)^T dO (JAX keeps p in fp32 for dv; rounding it to bf16 makes it
// a tensor-core operand, as on the TPU's MXU at default precision).

#include "flash_common.cuh"

namespace {

using namespace flash;
using namespace hopper;

struct BwdParams {
  const __nv_bfloat16* o;     // [B, S, H, D] strided (dq: delta's O)
  const __nv_bfloat16* dout;  // [B, S, H, D] strided
  const float* lse;           // [B, H, S] base 2
  float* delta;               // [B, H, S]: written by dq, read by dkv
  __nv_bfloat16* dq;          // [B, S, H, D] contiguous
  __nv_bfloat16* dk;          // [B, T, Hkv, D] contiguous
  __nv_bfloat16* dv;          // [B, T, Hkv, D] contiguous
  const int* seg_q;           // [B, S] or null (unmasked)
  const int* seg_kv;          // [B, T] or null
  int B, S, T, H, Hkv;
  int64_t o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  int causal, causal_offset, window;
  float c;         // softmax_scale * log2(e)
  float sm_scale;  // softmax_scale
  Rotary rot;      // fused-rotary tables (kRot only)
};

// ---- per-row values, the q walk -------------------------------------------

// -lse for p = exp2(s*c - lse), or -inf on a dead row (LSE -1e30) and past
// n_rows: p is then exactly 0.
__device__ __forceinline__ float neg_lse(float lse) {
  return lse <= 0.5f * kNegInf ? -INFINITY : -lse;
}

// This thread's part of rowsum(a * b) for one row: D / 4 columns from
// tq * D / 4; the quad's four parts sum to the row's.
template <int D>
__device__ __forceinline__ float row_dot(const __nv_bfloat16* a, int64_t sa, const __nv_bfloat16* b, int64_t sb,
                                         int row, int n_rows, int tq) {
  constexpr int kCols = D / 4;
  float sum = 0.f;
  if (row < n_rows) {
    const __nv_bfloat16* pa = a + row * sa + tq * kCols;
    const __nv_bfloat16* pb = b + row * sb + tq * kCols;
#pragma unroll
    for (int i = 0; i < kCols; i += 8) {
      const uint4 x = *reinterpret_cast<const uint4*>(pa + i), y = *reinterpret_cast<const uint4*>(pb + i);
      const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 u = unpack_bf16(xs[j]), w = unpack_bf16(ys[j]);
        sum = fmaf(u.x, w.x, sum);
        sum = fmaf(u.y, w.y, sum);
      }
    }
  }
  return sum;
}

// The q tiles (per q head) a kv tile [kv_lo, kv_hi] meets.
__device__ __forceinline__ int q_walk(const BwdParams& p, int kv_lo, int kv_hi, int w2, int* begin) {
  int q_begin = 0, q_end = p.S;
  if (p.causal) q_begin = max(0, kv_lo - p.causal_offset);
  if (w2 >= 0) {
    q_begin = max(q_begin, kv_lo - w2);
    q_end = min(q_end, kv_hi + w2 + 1);
  }
  q_begin = q_begin / kWalk * kWalk;
  *begin = q_begin;
  return q_end > q_begin ? (q_end - q_begin + kWalk - 1) / kWalk : 0;
}

// ---- the kernels -------------------------------------------------------------

// dq for items (b, h, tile of kRows q rows), and delta of their rows.
// fixed: q, dO; walked: k, v, with the kv tile's segment ids.
template <int D, int kC, bool kRot>
__global__ void __launch_bounds__(Cfg<D, kC, kRot>::kThreads, Cfg<D, kC, kRot>::kBlocksPerSM)
    flash_bwd_dq_kernel(const __grid_constant__ Maps maps, const BwdParams p) {
  using C = Cfg<D, kC, kRot>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const Pipe<C> pp = pipe_init<C>(smem);
  const int n_tiles = (p.S + C::kRows - 1) / C::kRows, items = p.B * p.H * n_tiles;
  const int group = p.H / p.Hkv, w2 = p.window > 0 ? p.window / 2 : -1;
  const bool has_seg = p.seg_q != nullptr;

  if (threadIdx.x >= C::kConsumerThreads) {  // the producer warpgroup: a loading warp, three rotators
    if constexpr (C::kShiftRegs) setmaxnreg_dec<C::kProducerRegs>();
    const int ptid = threadIdx.x - C::kConsumerThreads;
    if (ptid >= 32) {
      if constexpr (kRot) {  // the kv tiles' k rows, once per stage
        int step = 0;
        for (int item = blockIdx.x; item < items; item += gridDim.x) {
          const int q_lo = (item % n_tiles) * C::kRows, b = item / n_tiles / p.H;
          int kv0;
          const int steps = kv_walk(p.T, p.causal, p.causal_offset, q_lo, min(q_lo + C::kRows, p.S) - 1, w2, &kv0);
          for (int i = 0; i < steps; ++i, ++step, kv0 += kWalk)
            rotate_step<D>(pp, step, kv0, p.T, p.rot.cos + b * p.rot.sb, p.rot.sin + b * p.rot.sb, p.rot,
                           ptid - 32);
        }
      }
      return;
    }
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      prefetch_map(&maps.fixed0);
      prefetch_map(&maps.walked0);
    }
    const int tab_half = kRot && !p.rot.interleaved ? p.rot.half : 0;  // table entries per row, staged by TMA
    int step = 0;
    for (int item = blockIdx.x, n = 0; item < items; item += gridDim.x, ++n) {
      const int q_lo = (item % n_tiles) * C::kRows, h = (item / n_tiles) % p.H, b = item / n_tiles / p.H;
      const int tb = p.rot.sb ? b : 0;
      if (lane == 0) produce_item<D>(pp, maps, n, h, q_lo, b);
      int kv0;
      const int steps = kv_walk(p.T, p.causal, p.causal_offset, q_lo, min(q_lo + C::kRows, p.S) - 1, w2, &kv0);
      for (int i = 0; i < steps; ++i, ++step, kv0 += kWalk)
        produce_kv_stage<D, kRot>(pp, maps, step, lane, h / group, kv0, b, p.T, p.seg_kv, tab_half, tb);
    }
    return;
  }

  if constexpr (C::kShiftRegs) setmaxnreg_inc<C::kConsumerRegs>();
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  int step = 0;
  for (int item = blockIdx.x, n = 0; item < items; item += gridDim.x, ++n) {
    const int q_lo = (item % n_tiles) * C::kRows, h = (item / n_tiles) % p.H, b = item / n_tiles / p.H;
    const int r0 = q_lo + wg * 64 + (t / 32) * 16 + g, r1 = r0 + 8;  // this thread's rows
    const int64_t row0 = (int64_t(b) * p.H + h) * p.S;
    const float nl0 = neg_lse(r0 < p.S ? p.lse[row0 + r0] : kNegInf);
    const float nl1 = neg_lse(r1 < p.S ? p.lse[row0 + r1] : kNegInf);
    int sq0 = 1, sq1 = 1;  // unmasked: one segment
    if (has_seg) {
      sq0 = r0 < p.S ? p.seg_q[b * p.S + r0] : 0;
      sq1 = r1 < p.S ? p.seg_q[b * p.S + r1] : 0;
    }
    // delta = rowsum(dO * O), written for the dkv kernel
    const __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
    const __nv_bfloat16* db = p.dout + b * p.do_sb + h * p.do_sh;
    const float dl0 = quad_sum(row_dot<D>(db, p.do_ss, ob, p.o_ss, r0, p.S, tq));
    const float dl1 = quad_sum(row_dot<D>(db, p.do_ss, ob, p.o_ss, r1, p.S, tq));
    if (tq == 0) {
      if (r0 < p.S) p.delta[row0 + r0] = dl0;
      if (r1 < p.S) p.delta[row0 + r1] = dl1;
    }
    const float* tcos = kRot ? p.rot.cos + b * p.rot.sb : nullptr;
    const float* tsin = kRot ? p.rot.sin + b * p.rot.sb : nullptr;

    const int slot = n % C::kSlots;
    mbar_wait(pp.slot_full(slot), (n / C::kSlots) & 1);
    const uint32_t q_s = pp.slot(slot), do_s = q_s + C::kFixedBytes;
    if constexpr (kRot) {  // this warpgroup's q rows, once per item
      rotate_rows<D>(pp.slot_ptr(slot), C::kRows, q_lo, p.S, tcos, tsin, p.rot, t, 128, wg * 64, wg * 64 + 64);
      fence_proxy_async();
      named_bar_sync(2 + wg);
    }

    float acc[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    int kv0;
    const int steps = kv_walk(p.T, p.causal, p.causal_offset, q_lo, min(q_lo + C::kRows, p.S) - 1, w2, &kv0);
    for (int i = 0; i < steps; ++i, ++step, kv0 += kWalk) {
      const int s = step % C::kStages;
      mbar_wait(pp.full(s), (step / C::kStages) & 1);
      const uint32_t k_s = pp.stage(s), v_s = k_s + C::kWalkBytes;
      float sc[8][4], dp[8][4];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(sc, kmajor_desc(q_s, C::kRows, wg, kk), kmajor_desc(k_s, kWalk, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dp, kmajor_desc(do_s, C::kRows, wg, kk), kmajor_desc(v_s, kWalk, 0, kk), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      fence_acc(dp);

      // ds = p * (dp - delta) * softmax_scale, written over sc; a warp whose
      // rows all share the kv tile's one segment, with no band, takes the
      // branch-free form
      const int uni = *pp.template extra<int>(s, 3);
      if (__all_sync(0xffffffffu, !p.causal && w2 < 0 && uni > 0 && sq0 == uni && sq1 == uni)) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pij = exp2f(fmaf(sc[j][e], p.c, e < 2 ? nl0 : nl1));
            sc[j][e] = pij * (dp[j][e] - (e < 2 ? dl0 : dl1)) * p.sm_scale;
          }
      } else {
        const int* seg = pp.template extra<int>(s, 0);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int cl = j * 8 + tq * 2 + (e & 1), col = kv0 + cl;
            const bool top = e < 2;
            bool ok = col < p.T && in_band(top ? r0 : r1, col, p.causal, p.causal_offset, w2);
            if (has_seg) ok = ok && (top ? sq0 : sq1) == seg[cl] && seg[cl] != 0;
            const float pij = ok ? exp2f(fmaf(sc[j][e], p.c, top ? nl0 : nl1)) : 0.f;
            sc[j][e] = pij * (dp[j][e] - (top ? dl0 : dl1)) * p.sm_scale;
          }
      }
      uint32_t a[4][4];
      to_frag(a, sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(acc, a[kk], mnmajor_desc(k_s, kk));  // dq += bf16(ds) k
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      fence_frag(a);
      if (lane == 0) mbar_arrive(pp.empty(s));  // this warp is done with the stage
    }
    if (lane == 0) mbar_arrive(pp.slot_empty(slot));

    if constexpr (kRot) rotate_adjoint<D>(acc, tcos, tsin, r0, tq, p.rot, p.S);  // dq wrt the unrotated q
    const int64_t row_stride = int64_t(p.H) * D;
    store_rows<D>(p.dq + int64_t(b) * p.S * row_stride + int64_t(h) * D, row_stride, acc, r0, p.S, tq);
  }
}

// dk, dv for items (b, kv head, tile of kRows kv rows). fixed: k, v; walked:
// q, dO of each q head of the GQA group, with the q tile's -LSE, delta and
// segment ids.
template <int D, int kC, bool kRot>
__global__ void __launch_bounds__(Cfg<D, kC, kRot>::kThreads, Cfg<D, kC, kRot>::kBlocksPerSM)
    flash_bwd_dkv_kernel(const __grid_constant__ Maps maps, const BwdParams p) {
  using C = Cfg<D, kC, kRot>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const Pipe<C> pp = pipe_init<C>(smem);
  const int n_tiles = (p.T + C::kRows - 1) / C::kRows, items = p.B * p.Hkv * n_tiles;
  const int group = p.H / p.Hkv, w2 = p.window > 0 ? p.window / 2 : -1;
  const bool has_seg = p.seg_q != nullptr;

  if (threadIdx.x >= C::kConsumerThreads) {  // the producer warpgroup: a loading warp, three rotators
    if constexpr (C::kShiftRegs) setmaxnreg_dec<C::kProducerRegs>();
    const int ptid = threadIdx.x - C::kConsumerThreads;
    if (ptid >= 32) {
      if constexpr (kRot) {  // the q tiles' rows, once per stage
        int step = 0;
        for (int item = blockIdx.x; item < items; item += gridDim.x) {
          const int kv_lo = (item % n_tiles) * C::kRows, b = item / n_tiles / p.Hkv;
          int q_begin;
          const int steps = q_walk(p, kv_lo, min(kv_lo + C::kRows, p.T) - 1, w2, &q_begin);
          for (int m = 0; m < group; ++m)
            for (int i = 0, q0 = q_begin; i < steps; ++i, ++step, q0 += kWalk)
              rotate_step<D>(pp, step, q0, p.S, p.rot.cos + b * p.rot.sb, p.rot.sin + b * p.rot.sb, p.rot,
                             ptid - 32);
        }
      }
      return;
    }
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      prefetch_map(&maps.fixed0);
      prefetch_map(&maps.walked0);
    }
    const int tab_half = kRot && !p.rot.interleaved ? p.rot.half : 0;  // table entries per row, staged by TMA
    int step = 0;
    for (int item = blockIdx.x, n = 0; item < items; item += gridDim.x, ++n) {
      const int kv_lo = (item % n_tiles) * C::kRows, hk = (item / n_tiles) % p.Hkv, b = item / n_tiles / p.Hkv;
      const int tb = p.rot.sb ? b : 0;
      if (lane == 0) produce_item<D>(pp, maps, n, hk, kv_lo, b);
      int q_begin;
      const int steps = q_walk(p, kv_lo, min(kv_lo + C::kRows, p.T) - 1, w2, &q_begin);
      for (int m = 0; m < group; ++m) {
        const int h = hk * group + m;
        const int64_t row0 = (int64_t(b) * p.H + h) * p.S;
        for (int i = 0, q0 = q_begin; i < steps; ++i, ++step, q0 += kWalk) {
          // the q tile's per-row values (rows past S are dead: -LSE = -inf),
          // read before waiting for the stage so that the wait hides their
          // latency
          float nl[2], dl[2];
          int sg[2];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int qr = q0 + lane + 32 * k;
            const bool in = qr < p.S;
            nl[k] = in ? __ldg(p.lse + row0 + qr) : kNegInf;
            dl[k] = in ? __ldg(p.delta + row0 + qr) : 0.f;
            sg[k] = !in ? 0 : has_seg ? __ldg(p.seg_q + b * p.S + qr) : 1;
          }
          const int s = produce_wait(pp, step);
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            pp.template extra<float>(s, 0)[lane + 32 * k] = neg_lse(nl[k]);
            pp.template extra<float>(s, 1)[lane + 32 * k] = dl[k];
            pp.template extra<int>(s, 2)[lane + 32 * k] = sg[k];
          }
          produce_stage<D, kRot>(pp, maps, s, lane, h, q0, b, sg[0], sg[1], tab_half, tb);
        }
      }
    }
    return;
  }

  if constexpr (C::kShiftRegs) setmaxnreg_inc<C::kConsumerRegs>();
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  int step = 0;
  for (int item = blockIdx.x, n = 0; item < items; item += gridDim.x, ++n) {
    const int kv_lo = (item % n_tiles) * C::kRows, hk = (item / n_tiles) % p.Hkv, b = item / n_tiles / p.Hkv;
    const int r0 = kv_lo + wg * 64 + (t / 32) * 16 + g, r1 = r0 + 8;  // this thread's kv rows
    int skv0 = r0 < p.T, skv1 = r1 < p.T;  // unmasked: one segment
    if (has_seg) {
      skv0 = r0 < p.T ? p.seg_kv[b * p.T + r0] : 0;
      skv1 = r1 < p.T ? p.seg_kv[b * p.T + r1] : 0;
    }
    const float* tcos = kRot ? p.rot.cos + b * p.rot.sb : nullptr;
    const float* tsin = kRot ? p.rot.sin + b * p.rot.sb : nullptr;

    const int slot = n % C::kSlots;
    mbar_wait(pp.slot_full(slot), (n / C::kSlots) & 1);
    const uint32_t k_s = pp.slot(slot), v_s = k_s + C::kFixedBytes;
    if constexpr (kRot) {  // this warpgroup's k rows, once per item
      rotate_rows<D>(pp.slot_ptr(slot), C::kRows, kv_lo, p.T, tcos, tsin, p.rot, t, 128, wg * 64, wg * 64 + 64);
      fence_proxy_async();
      named_bar_sync(2 + wg);
    }

    float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
      dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
    }
    int q_begin;
    const int steps = q_walk(p, kv_lo, min(kv_lo + C::kRows, p.T) - 1, w2, &q_begin);
    for (int m = 0; m < group; ++m) {
      for (int i = 0, q0 = q_begin; i < steps; ++i, ++step, q0 += kWalk) {
        const int s = step % C::kStages;
        mbar_wait(pp.full(s), (step / C::kStages) & 1);
        const uint32_t q_s = pp.stage(s), do_s = q_s + C::kWalkBytes;
        const float* nlse = pp.template extra<float>(s, 0);
        const float* delta = pp.template extra<float>(s, 1);
        const int* seg = pp.template extra<int>(s, 2);
        // transposed products: rows are this warpgroup's kv rows, columns q rows
        float st[8][4], dpt[8][4];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(st, kmajor_desc(k_s, C::kRows, wg, kk), kmajor_desc(q_s, kWalk, 0, kk), kk);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(dpt, kmajor_desc(v_s, C::kRows, wg, kk), kmajor_desc(do_s, kWalk, 0, kk), kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(st);
        fence_acc(dpt);

        // p^T over st, ds^T over dpt; a warp whose kv rows all share the q
        // tile's one segment, with no band, takes the branch-free form
        const int uni = *pp.template extra<int>(s, 3);
        if (__all_sync(0xffffffffu, !p.causal && w2 < 0 && uni > 0 && skv0 == uni && skv1 == uni)) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            // this thread's two q rows (columns) of block j: their -LSE and delta
            const float2 nl = *reinterpret_cast<const float2*>(nlse + j * 8 + tq * 2);
            const float2 dl = *reinterpret_cast<const float2*>(delta + j * 8 + tq * 2);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float pij = exp2f(fmaf(st[j][e], p.c, e & 1 ? nl.y : nl.x));
              st[j][e] = pij;
              dpt[j][e] = pij * (dpt[j][e] - (e & 1 ? dl.y : dl.x)) * p.sm_scale;
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int cl = j * 8 + tq * 2 + (e & 1), kvr = e < 2 ? r0 : r1, skv = e < 2 ? skv0 : skv1;
              const bool ok = kvr < p.T && in_band(q0 + cl, kvr, p.causal, p.causal_offset, w2) && seg[cl] == skv &&
                              skv != 0;
              const float pij = ok ? exp2f(fmaf(st[j][e], p.c, nlse[cl])) : 0.f;
              st[j][e] = pij;
              dpt[j][e] = pij * (dpt[j][e] - delta[cl]) * p.sm_scale;
            }
        }
        uint32_t pa[4][4], da[4][4];
        to_frag(pa, st);
        to_frag(da, dpt);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dv, pa[kk], mnmajor_desc(do_s, kk));  // dv += bf16(p)^T dO
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dk, da[kk], mnmajor_desc(q_s, kk));   // dk += bf16(ds)^T q
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(dv);
        fence_acc(dk);
        fence_frag(pa);
        fence_frag(da);
        if (lane == 0) mbar_arrive(pp.empty(s));  // this warp is done with the stage
      }
    }
    if (lane == 0) mbar_arrive(pp.slot_empty(slot));

    const int64_t row_stride = int64_t(p.Hkv) * D;
    const int64_t base = int64_t(b) * p.T * row_stride + int64_t(hk) * D;
    store_rows<D>(p.dv + base, row_stride, dv, r0, p.T, tq);
    if constexpr (kRot) rotate_adjoint<D>(dk, tcos, tsin, r0, tq, p.rot, p.T);  // dk wrt the unrotated k
    store_rows<D>(p.dk + base, row_stride, dk, r0, p.T, tq);
  }
}

BwdParams make_params(const void* o, const void* dout, const void* lse, void* delta, const void* seg_q,
                      const void* seg_kv, int B, int S, int T, int H, int Hkv, int64_t o_sb, int64_t o_ss,
                      int64_t o_sh, int64_t do_sb, int64_t do_ss, int64_t do_sh, int causal, int causal_offset,
                      int window, float c, float sm_scale, const void* rot_cos, const void* rot_sin,
                      int64_t rot_sb, int rot_half, int rot_interleaved) {
  BwdParams p = {};
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_kv = static_cast<const int*>(seg_kv);
  p.B = B; p.S = S; p.T = T; p.H = H; p.Hkv = Hkv;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.do_sb = do_sb; p.do_ss = do_ss; p.do_sh = do_sh;
  p.causal = causal; p.causal_offset = causal_offset; p.window = window;
  p.c = c;
  p.sm_scale = sm_scale;
  p.rot = Rotary{static_cast<const float*>(rot_cos), static_cast<const float*>(rot_sin), rot_sb, rot_half,
                 rot_interleaved};
  return p;
}

template <int D, int kC, bool kRot>
cudaError_t launch_dq(const Maps& maps, const BwdParams& p, cudaStream_t st) {
  using C = Cfg<D, kC, kRot>;
  static bool ready = false;
  const int items = p.B * p.H * ((p.S + C::kRows - 1) / C::kRows);
  return launch<C>(flash_bwd_dq_kernel<D, kC, kRot>, &ready, maps, p, items, st);
}

template <int D, int kC, bool kRot>
cudaError_t launch_dkv(const Maps& maps, const BwdParams& p, cudaStream_t st) {
  using C = Cfg<D, kC, kRot>;
  static bool ready = false;
  const int items = p.B * p.Hkv * ((p.T + C::kRows - 1) / C::kRows);
  return launch<C>(flash_bwd_dkv_kernel<D, kC, kRot>, &ready, maps, p, items, st);
}

// Rows of an item: 128 (two warpgroups) at D = 64 when the item's rows
// (S for dq, T for dk/dv) fill more than one warpgroup, else 64.
int item_rows(int D, int n_rows) { return D == 64 && n_rows > 64 ? 128 : 64; }

}  // namespace

// C entry points, loaded with ctypes. Each launches on `stream`, does not
// synchronise and allocates nothing; each returns cudaGetLastError() (or
// the error that stopped it first) so the caller sees a refused launch
// (bad shape, too many resources) at once. q, k, v, O and dO: unit stride
// over D, other strides and the pointers 16-byte aligned (TMA; the wrapper
// checks). rot_cos == NULL runs the plain variant; otherwise the
// fused-rotary one, with the tables and rules of flash_fwd_bf16 (S == T,
// rot_half % 8 == 0).
//
// flash_bwd_dq_bf16 writes dq and delta = rowsum(dO * O) [B, H, S] fp32;
// flash_bwd_dkv_bf16 reads that delta, so it runs after dq on one stream.
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout, const void* o,
                                 const void* lse, void* delta, void* dq, const void* seg_q, const void* seg_kv,
                                 int B, int S, int T, int H, int Hkv, int D, int64_t q_sb, int64_t q_ss,
                                 int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                                 int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh, int64_t do_sb,
                                 int64_t do_ss, int64_t do_sh, int causal, int causal_offset, int window, float c,
                                 float sm_scale, const void* rot_cos, const void* rot_sin, int64_t rot_sb,
                                 int rot_half, int rot_interleaved, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || (D != 64 && D != 128) || !rot_ok(rot_cos, rot_half, D))
    return int(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || H == 0) return int(cudaSuccess);
  BwdParams p = make_params(o, dout, lse, delta, seg_q, seg_kv, B, S, T, H, Hkv, o_sb, o_ss, o_sh, do_sb, do_ss,
                            do_sh, causal, causal_offset, window, c, sm_scale, rot_cos, rot_sin, rot_sb, rot_half,
                            rot_interleaved);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  const int rows = item_rows(D, S);
  Maps maps = {};
  if (!operand_map(&maps.fixed0, q, D, H, S, B, q_sb, q_ss, q_sh, rows) ||
      !operand_map(&maps.fixed1, dout, D, H, S, B, do_sb, do_ss, do_sh, rows) || !rotary_maps(&maps, p.rot, D, S, B))
    return int(cudaErrorInvalidValue);
  if (T == 0) {  // no kv tile is loaded: every row gets dq = 0 and its delta
    maps.walked0 = maps.walked1 = maps.fixed0;
  } else if (!operand_map(&maps.walked0, k, D, Hkv, T, B, k_sb, k_ss, k_sh, kWalk) ||
             !operand_map(&maps.walked1, v, D, Hkv, T, B, v_sb, v_ss, v_sh, kWalk)) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fused = rot_cos != nullptr;
  if (D == 128) return int(fused ? launch_dq<128, 1, true>(maps, p, s) : launch_dq<128, 1, false>(maps, p, s));
  if (rows == 64) return int(fused ? launch_dq<64, 1, true>(maps, p, s) : launch_dq<64, 1, false>(maps, p, s));
  return int(fused ? launch_dq<64, 2, true>(maps, p, s) : launch_dq<64, 2, false>(maps, p, s));
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv, const void* seg_q, const void* seg_kv,
                                  int B, int S, int T, int H, int Hkv, int D, int64_t q_sb, int64_t q_ss,
                                  int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                                  int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh, int causal,
                                  int causal_offset, int window, float c, float sm_scale, const void* rot_cos,
                                  const void* rot_sin, int64_t rot_sb, int rot_half, int rot_interleaved,
                                  void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || (D != 64 && D != 128) || !rot_ok(rot_cos, rot_half, D))
    return int(cudaErrorInvalidValue);
  if (B == 0 || T == 0 || Hkv == 0) return int(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S == 0 || H == 0) {  // no q row: dk = dv = 0
    const size_t bytes = size_t(B) * T * Hkv * D * sizeof(__nv_bfloat16);
    const cudaError_t err = cudaMemsetAsync(dk, 0, bytes, s);
    return int(err != cudaSuccess ? err : cudaMemsetAsync(dv, 0, bytes, s));
  }
  BwdParams p = make_params(nullptr, dout, lse, const_cast<void*>(delta), seg_q, seg_kv, B, S, T, H, Hkv, 0, 0, 0,
                            o_sb, o_ss, o_sh, causal, causal_offset, window, c, sm_scale, rot_cos, rot_sin, rot_sb,
                            rot_half, rot_interleaved);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  const int rows = item_rows(D, T);
  Maps maps = {};
  if (!operand_map(&maps.fixed0, k, D, Hkv, T, B, k_sb, k_ss, k_sh, rows) ||
      !operand_map(&maps.fixed1, v, D, Hkv, T, B, v_sb, v_ss, v_sh, rows) ||
      !operand_map(&maps.walked0, q, D, H, S, B, q_sb, q_ss, q_sh, kWalk) ||
      !operand_map(&maps.walked1, dout, D, H, S, B, o_sb, o_ss, o_sh, kWalk) || !rotary_maps(&maps, p.rot, D, S, B))
    return int(cudaErrorInvalidValue);
  const bool fused = rot_cos != nullptr;
  if (D == 128) return int(fused ? launch_dkv<128, 1, true>(maps, p, s) : launch_dkv<128, 1, false>(maps, p, s));
  if (rows == 64) return int(fused ? launch_dkv<64, 1, true>(maps, p, s) : launch_dkv<64, 1, false>(maps, p, s));
  return int(fused ? launch_dkv<64, 2, true>(maps, p, s) : launch_dkv<64, 2, false>(maps, p, s));
}
