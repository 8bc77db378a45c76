// Flash-attention forward for Hopper (sm_90a): bf16 q/k/v/O, fp32 LSE.
//
// Replaces the two Pallas TPU forward kernels of
// contrastors_tpu/ops/flash_attention.py, both launched by _fwd (:338, call
// :396):
//   _fwd_kernel_single (:225) - the whole kv range in one block (T <= 2048),
//   _fwd_kernel        (:115) - multi-block FA-2 online softmax (T > 2048),
// and their fused_rot=True forms (the kRot template flag here), which also
// stand for the ablation's prototype _fused_fwd_kernel
// (scripts/ablate_rotary_fusion.py:42). On the TPU the multi-block kernel
// carries m, l and the accumulator in VMEM scratch across the sequential kv
// grid axis, and the single-block one exists to fit VMEM. Here one kernel
// covers both: a block owns a tile of q rows of one (batch, head) (an
// "item") and walks the 64-row kv tiles as a loop, with an online softmax
// whose m, l and accumulator stay in fp32 registers; T within one tile is a
// walk of one step.
//
// What bounds it on an H100: per (batch, head) the work is 4*S*T*D FLOP
// against 8*S*D bytes of q, k, v and O (S == T), i.e. T/2 FLOP per byte.
// That is ~256 at the encode length T=512, just under the card's ~295
// FLOP/byte balance point for bf16, so the function is bound by bytes at
// T <= 512 and by tensor-core operations above it. Only wgmma reaches the
// tensor cores' full rate, and only when its operands are in shared memory
// ahead of it. Beside the products, the softmax costs a thread ~8
// instructions per (row, col) pair at D = 64, one of them on the SFU
// (exp2), so the consumers are bound by issue and latency unless enough
// warps run beside each other. The design is the backward dq kernel's
// (flash_bwd.cu), with an online softmax in place of the LSE and no dp
// product; the pipeline is shared (flash_common.cuh):
//   - Warp-specialised, persistent blocks: a producer warpgroup (one warp
//     loads; with rotary the other three rotate) and kC consumer
//     warpgroups, each owning 64 q rows of the item: three (192-row items)
//     at D = 64 when S > 256, one when S <= 64 (then two one-warpgroup
//     blocks share an SM), two otherwise and at D = 128. `setmaxnreg`
//     moves registers from the producer (56 a thread) to the consumers
//     (152 with three, 224 with two, 200 with one). The grid is as many
//     blocks as fit on the SMs; the items are the q tiles of each (batch,
//     head), adjacent tiles of one head together, so that a head's k and v
//     stay in L2.
//   - The item's q is one TMA load (cp.async.bulk.tensor, 128-byte swizzle,
//     a 4-D tensor map over the strided [B, S, H, D] storage, a row of D =
//     128 being two 64-wide boxes) into one of two slots, so the next
//     item's q loads while this one computes. The walked k and v tiles go
//     through a ring of 64-row stages (4 at D = 64 with two or three
//     consumers), each filled by TMA behind a full and an empty mbarrier;
//     views of the fused Wqkv output need no copy, and TMA zero-fills rows
//     past T. The producer's lanes read the kv tile's segment ids before
//     waiting for the stage, write them and the id the whole tile shares
//     (or -1), and arrive on its full barrier.
//   - Products: s = q k^T by wgmma m64n64k16 from shared memory (both
//     operands K-major); p in fp32 registers, cast to bf16 in the registers
//     as wgmma's A operand (the accumulator layout of one 16-deep step is the
//     A layout), so O += p v reads only v from shared memory, MN-major
//     through the transpose bit: no copies. The consumer warpgroups take
//     turns issuing s = q k^T (named barriers, FA3's ping-pong), so that
//     one's softmax runs under the others' products.
//   - The softmax: a warp whose rows all share the kv tile's one segment (an
//     unmasked or all-ones mask, a whole tile; rows past S, never stored,
//     count as sharing it), with no band, takes a branch-free form; the
//     others test every (row, col) pair (ragged tail, segments, causal,
//     window) with bitwise tests and a select: `&&` around the ids' loads
//     compiled into a divergent branch per element, 3.6x the time of an
//     all-ones batch on a padded one. Dead tiles under causal or window
//     masking are skipped, as the JAX kernels skip them; a kv tile whose
//     keys are all masked (padding) skips its softmax and PV product after
//     its s product, which is exact (p = 0). Skipping every tile of a
//     warpgroup whose rows are all masked was exact too, but cost 10% on
//     unmasked inputs and is not done. The exponentials
//     are the SFU's ex2.approx.ftz: one instruction, where exp2f adds a
//     range check and two multiplies to keep subnormal results (the TPU
//     flushes them too).
//   - The epilogue: O = acc / l cast to bf16 and stored by each thread for
//     its two rows; the LSE by the quad's leader. Every output row has one
//     owner and its sum a fixed order: no atomics, and two runs on the same
//     inputs are bit-identical.
// Dynamic shared memory per block (Cfg::kSmemBytes): 100 / 164 KiB (plain
// / rotary) with two warpgroups at D = 64, 116 / 180 KiB with three, 51 / 83
// KiB with one; 163 / 195 KiB at D = 128.
//
// Fused rotary (kRot; the tables are fp32 rows of D columns, duplicated
// halves for NeoX, repeated pairs for GPT-J, identity rows past rot_dim and
// past S): the consumers rotate their q rows once per item, from the tables
// in device memory, before a proxy fence and a named barrier (wgmma reads
// shared memory through the async proxy); the producer warpgroup's three
// other warps rotate each walked k tile once per stage, off the consumers'
// path: they wait for the stage's bytes (its raw barrier), rotate it in
// shared memory, NeoX from the entries TMA staged beside it, GPT-J from the
// tables in device memory (TMA with element stride 2 never completes),
// fence, and arrive on its full barrier. Products and the sum are rounded
// apart, then cast once: bit-identical to the plain version's rotated bf16
// operands.
//
// Semantics follow the JAX kernels exactly:
//   s = q.k^T in fp32, unscaled; c = softmax_scale*log2(e) enters only as
//   p = exp2(s*c - m*c); the row max is floored at -1e20/c so a fully masked
//   tile gives p == 0; p is cast to bf16 for the PV product;
//   masks: seg_q == seg_kv != 0, bottom-right causal row + off >= col,
//   window |row - col| <= window/2; GQA kv head = h / (H / Hkv);
//   O = acc / l (0 where l == 0), LSE = m*c + log2(l) (-1e30 where l == 0);
//   p below 2^-126 flushes to 0 (ex2.approx.ftz).

#include "flash_common.cuh"

namespace {

using namespace flash;

struct FwdParams {
  __nv_bfloat16* o;   // [B, S, H, D] contiguous
  float* lse;         // [B, H, S]
  const int* seg_q;   // [B, S] or null (unmasked)
  const int* seg_kv;  // [B, T] or null
  int B, S, T, H, Hkv;
  int causal, causal_offset, window;
  float c;    // softmax_scale * log2(e)
  Rotary rot;  // fused-rotary tables (kRot only)
};

// O and LSE for items (b, h, tile of kRows q rows). fixed: q; walked: k, v,
// with the kv tile's segment ids.
template <int D, int kC, bool kRot>
__global__ void __launch_bounds__(Cfg<D, kC, kRot, 1>::kThreads, Cfg<D, kC, kRot, 1>::kBlocksPerSM)
    flash_fwd_kernel(const __grid_constant__ Maps maps, const FwdParams p) {
  using C = Cfg<D, kC, kRot, 1>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const Pipe<C> pp = pipe_init<C>(smem);
  const int n_tiles = (p.S + C::kRows - 1) / C::kRows, items = p.B * p.H * n_tiles;
  const int group = p.H / p.Hkv, w2 = p.window > 0 ? p.window / 2 : -1;

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
  const bool has_seg = p.seg_q != nullptr;
  const float c = p.c, m_floor = -1e20f / c;
  // two or three warpgroups take turns issuing s = q k^T (named barrier 5 +
  // wg is this warpgroup's turn, 256 threads: its own and the previous
  // one's arrival), so that one's softmax runs under the others' products;
  // warpgroup 0 goes first
  if (kC >= 2 && wg == kC - 1) named_bar_arrive(5, 256);
  int step = 0;
  for (int item = blockIdx.x, n = 0; item < items; item += gridDim.x, ++n) {
    const int q_lo = (item % n_tiles) * C::kRows, h = (item / n_tiles) % p.H, b = item / n_tiles / p.H;
    const int r0 = q_lo + wg * 64 + (t / 32) * 16 + g, r1 = r0 + 8;  // this thread's rows
    int sq0 = 1, sq1 = 1;  // unmasked: one segment
    if (has_seg) {
      sq0 = r0 < p.S ? p.seg_q[b * p.S + r0] : 0;
      sq1 = r1 < p.S ? p.seg_q[b * p.S + r1] : 0;
    }

    const int slot = n % C::kSlots;
    mbar_wait(pp.slot_full(slot), (n / C::kSlots) & 1);
    const uint32_t q_s = pp.slot(slot);
    if constexpr (kRot) {  // this warpgroup's q rows, once per item
      rotate_rows<D>(pp.slot_ptr(slot), C::kRows, q_lo, p.S, p.rot.cos + b * p.rot.sb, p.rot.sin + b * p.rot.sb,
                     p.rot, t, 128, wg * 64, wg * 64 + 64);
      fence_proxy_async();
      named_bar_sync(2 + wg);
    }

    float m0 = kNegInf, m1 = kNegInf;  // running row maxima (unscaled)
    float l0 = 0.f, l1 = 0.f;          // this thread's part of the row sums
    float acc[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    int kv0;
    const int steps = kv_walk(p.T, p.causal, p.causal_offset, q_lo, min(q_lo + C::kRows, p.S) - 1, w2, &kv0);
    for (int i = 0; i < steps; ++i, ++step, kv0 += kWalk) {
      const int s = step % C::kStages;
      mbar_wait(pp.full(s), (step / C::kStages) & 1);
      const uint32_t k_s = pp.stage(s), v_s = k_s + C::kWalkBytes;
      float sc[8][4];
      if (kC >= 2) named_bar_sync(5 + wg, 256);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(sc, kmajor_desc(q_s, C::kRows, wg, kk), kmajor_desc(k_s, kWalk, 0, kk), kk);
      wgmma_commit();
      if (kC >= 2) named_bar_arrive(5 + (wg + 1) % kC, 256);
      wgmma_wait<0>();
      fence_acc(sc);
      const int uni = *pp.template extra<int>(s, 3);
      if (uni == 0) {  // every key of the tile is masked: p = 0
        if (lane == 0) mbar_arrive(pp.empty(s));
        continue;
      }

      // masks: a warp whose rows all share the kv tile's one segment, with
      // no band, needs none (rows past S are never stored); the others set
      // s = -1e30 where a pair is out, without branches: the producer wrote
      // id 0 for columns past T (and 1 before T when unmasked, where every
      // row's id is 1)
      const bool same0 = sq0 == uni || r0 >= p.S, same1 = sq1 == uni || r1 >= p.S;
      if (!__all_sync(0xffffffffu, !p.causal && w2 < 0 && uni > 0 && same0 && same1)) {
        const int* seg = pp.template extra<int>(s, 0);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int2 sk = *reinterpret_cast<const int2*>(seg + j * 8 + tq * 2);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = kv0 + j * 8 + tq * 2 + (e & 1), id = e & 1 ? sk.y : sk.x;
            const bool ok = ((e < 2 ? sq0 : sq1) == id) & (id != 0) &
                            in_band(e < 2 ? r0 : r1, col, p.causal, p.causal_offset, w2);
            sc[j][e] = ok ? sc[j][e] : kNegInf;
          }
        }
      }

      // online softmax over the tile
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
        mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
      }
      mx0 = fmaxf(quad_max(mx0), m_floor);
      mx1 = fmaxf(quad_max(mx1), m_floor);
      const float corr0 = exp2_ftz((m0 - mx0) * c), corr1 = exp2_ftz((m1 - mx1) * c);
      const float mc0 = mx0 * c, mc1 = mx1 * c;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sc[j][0] = exp2_ftz(fmaf(sc[j][0], c, -mc0));
        sc[j][1] = exp2_ftz(fmaf(sc[j][1], c, -mc0));
        sc[j][2] = exp2_ftz(fmaf(sc[j][2], c, -mc1));
        sc[j][3] = exp2_ftz(fmaf(sc[j][3], c, -mc1));
        sum0 += sc[j][0] + sc[j][1];
        sum1 += sc[j][2] + sc[j][3];
      }
      l0 = l0 * corr0 + sum0;
      l1 = l1 * corr1 + sum1;
      m0 = mx0;
      m1 = mx1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][0] *= corr0;
        acc[j][1] *= corr0;
        acc[j][2] *= corr1;
        acc[j][3] *= corr1;
      }

      // O += bf16(p) v
      uint32_t a[4][4];
      to_frag(a, sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(acc, a[kk], mnmajor_desc(v_s, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      fence_frag(a);
      if (lane == 0) mbar_arrive(pp.empty(s));  // this warp is done with the stage
    }
    if (lane == 0) mbar_arrive(pp.slot_empty(slot));

    // O = acc / l (0 where l == 0); LSE = m*c + log2(l) (-1e30 where l == 0)
    const float s0 = quad_sum(l0), s1 = quad_sum(l1);
    const float ls0 = s0 == 0.f ? 1.f : s0, ls1 = s1 == 0.f ? 1.f : s1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] /= ls0;
      acc[j][1] /= ls0;
      acc[j][2] /= ls1;
      acc[j][3] /= ls1;
    }
    const int64_t row_stride = int64_t(p.H) * D;
    store_rows<D>(p.o + int64_t(b) * p.S * row_stride + int64_t(h) * D, row_stride, acc, r0, p.S, tq);
    if (tq == 0) {
      const int64_t lrow = (int64_t(b) * p.H + h) * p.S;
      if (r0 < p.S) p.lse[lrow + r0] = s0 == 0.f ? kNegInf : m0 * c + log2f(ls0);
      if (r1 < p.S) p.lse[lrow + r1] = s1 == 0.f ? kNegInf : m1 * c + log2f(ls1);
    }
  }
  if (kC >= 2 && wg == 0) named_bar_sync(5, 256);  // the last warpgroup's last turn
}

template <int D, int kC, bool kRot>
cudaError_t launch_fwd(const Maps& maps, const FwdParams& p, cudaStream_t st) {
  using C = Cfg<D, kC, kRot, 1>;
  static bool ready = false;
  const int items = p.B * p.H * ((p.S + C::kRows - 1) / C::kRows);
  return launch<C>(flash_fwd_kernel<D, kC, kRot>, &ready, maps, p, items, st);
}

}  // namespace

// C entry point, loaded with ctypes. Launches on `stream`, does not
// synchronise and allocates nothing; returns cudaGetLastError() (or the
// error that stopped it first) so the caller sees a refused launch (bad
// shape, too many resources) at once. q, k, v: unit stride over D, other
// strides and the pointers 16-byte aligned (TMA; the wrapper checks).
// rot_cos == NULL runs the plain variant; otherwise q and k are rotated with
// the fp32 tables (rows of D, at least round_up(S, 64) of them, batch stride
// rot_sb), rot_half = rot_dim / 2 a multiple of 8, and S must equal T.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                              const void* seg_q, const void* seg_kv, int B, int S, int T, int H,
                              int Hkv, int D, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                              int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                              int64_t v_ss, int64_t v_sh, int causal, int causal_offset,
                              int window, float c, const void* rot_cos, const void* rot_sin,
                              int64_t rot_sb, int rot_half, int rot_interleaved, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || (D != 64 && D != 128) || !rot_ok(rot_cos, rot_half, D))
    return int(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || H == 0) return int(cudaSuccess);
  FwdParams p = {};
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_kv = static_cast<const int*>(seg_kv);
  p.B = B; p.S = S; p.T = T; p.H = H; p.Hkv = Hkv;
  p.causal = causal; p.causal_offset = causal_offset; p.window = window;
  p.c = c;
  p.rot = Rotary{static_cast<const float*>(rot_cos), static_cast<const float*>(rot_sin), rot_sb, rot_half,
                 rot_interleaved};
  // 128-row items (two consumer warpgroups), or 64 at D = 64 when S fills
  // at most one warpgroup
  const int rows = D == 64 && S <= 64 ? 64 : D == 64 && S > 256 ? 192 : 128;
  Maps maps = {};
  if (!operand_map(&maps.fixed0, q, D, H, S, B, q_sb, q_ss, q_sh, rows) || !rotary_maps(&maps, p.rot, D, S, B))
    return int(cudaErrorInvalidValue);
  if (T == 0) {  // no kv tile is loaded: every row gets O = 0 and LSE = -1e30
    maps.walked0 = maps.walked1 = maps.fixed0;
  } else if (!operand_map(&maps.walked0, k, D, Hkv, T, B, k_sb, k_ss, k_sh, kWalk) ||
             !operand_map(&maps.walked1, v, D, Hkv, T, B, v_sb, v_ss, v_sh, kWalk)) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fused = rot_cos != nullptr;
  if (D == 128) return int(fused ? launch_fwd<128, 2, true>(maps, p, s) : launch_fwd<128, 2, false>(maps, p, s));
  if (rows == 64) return int(fused ? launch_fwd<64, 1, true>(maps, p, s) : launch_fwd<64, 1, false>(maps, p, s));
  if (rows == 192) return int(fused ? launch_fwd<64, 3, true>(maps, p, s) : launch_fwd<64, 3, false>(maps, p, s));
  return int(fused ? launch_fwd<64, 2, true>(maps, p, s) : launch_fwd<64, 2, false>(maps, p, s));
}
