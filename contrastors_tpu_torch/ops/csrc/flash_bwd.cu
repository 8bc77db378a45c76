// Flash-attention backward for Hopper (sm_90a): bf16 q/k/v/dO/dq/dk/dv,
// fp32 LSE and delta.
//
// Replaces the two Pallas TPU backward kernels of
// contrastors_tpu/ops/flash_attention.py, both launched by _bwd (:608):
//   _bwd_dq_kernel  (:422, call :640) -> flash_bwd_dq_kernel,
//   _bwd_dkv_kernel (:512, call :700) -> flash_bwd_dkv_kernel.
// On the TPU each kernel carries its accumulator in VMEM scratch across the
// sequential innermost grid axis. Here a block owns one 64-row output tile
// and runs that axis as a loop inside the block, with the accumulator in
// fp32 registers:
//   dq:  one block per (64 q rows, head, batch), looping over kv tiles;
//   dkv: one block per (64 kv rows, kv head, batch), looping over the GQA
//        group's q heads x q tiles. dk and dv of a tile have one owner, so
//        no atomics are needed and the result is deterministic.
// Both recompute p from the forward's base-2 LSE instead of storing it.
//
// What bounds them on an H100: per (batch, q head) the dq kernel runs three
// products (s = q k^T, dp = dO v^T, dq = ds k) and the dkv kernel four
// (s, dp, dv = p^T dO, dk = ds^T q), each 2*D FLOP per live (row, col)
// pair, against q, k, v, dO read once and dq (or dk, dv) written once. At
// the training shapes (S = T = 32 and 256, D = 64) that is 3*S/4 or S FLOP
// per byte moved, below the card's ~295 FLOP/byte balance for bf16 at
// S = 32 and near it at S = 256: bytes bound the query tower and both
// bounds are close for documents. The design keeps s, p, dp and ds in
// registers, stages the tile that the loop walks through shared memory
// once per step, and runs every product on bf16 tensor cores (mma.sync
// m16n8k16, fp32 accumulation). Like flash_fwd.cu it is the simple first
// design: synchronous staging, no wgmma/TMA/cp.async pipelining, so it is
// expected to stay well short of both bounds. Dead tiles under causal or
// window masking are skipped, as the JAX kernels skip them.
//
// Fused rotary (flash_bwd_dq_rot / flash_bwd_dkv_rot, the template flag kRot
// of one body each; the JAX kernels' fused_rot=True,
// :426-446 and :516-545): both kernels recompute rotated q and k exactly as
// flash_fwd.cu does (q fragments rotated in registers, tiles rotated as they
// are staged), accumulate dq (dk) with respect to the rotated operand in
// fp32, and apply the rotation's adjoint g*cos + rot^T(g*sin) to the fp32
// accumulator before the single bf16 cast (JAX :502-509, :600-604). The
// partner column of every accumulator element lives in the same thread, so
// the adjoint needs no shared memory. dv is unchanged; delta stays outside.
//
// Semantics follow JAX _bwd: s = q.k^T * c (c = softmax_scale*log2(e)) with
// the forward's masks; p = exp2(s - lse), and p = 0 on rows whose LSE is
// -1e30 (fully masked rows have O = 0 and no gradient); dp = dO.v^T;
// ds = p * (dp - delta) * softmax_scale with delta = rowsum(dO * O) computed
// by the caller; dq = bf16(ds) k, dk = bf16(ds)^T q, dv = bf16(p)^T dO
// (JAX keeps p in fp32 for dv; rounding it to bf16 makes it a tensor-core
// operand, as on the TPU's MXU at default precision).

#include "flash_common.cuh"

namespace {

using namespace flash;

struct BwdParams {
  const __nv_bfloat16* q;     // [B, S, H, D] strided
  const __nv_bfloat16* k;     // [B, T, Hkv, D] strided
  const __nv_bfloat16* v;     // [B, T, Hkv, D] strided
  const __nv_bfloat16* dout;  // [B, S, H, D] strided
  const float* lse;           // [B, H, S] base 2
  const float* delta;         // [B, H, S]
  __nv_bfloat16* dq;          // [B, S, H, D] contiguous
  __nv_bfloat16* dk;          // [B, T, Hkv, D] contiguous
  __nv_bfloat16* dv;          // [B, T, Hkv, D] contiguous
  const int* seg_q;           // [B, S] or null (unmasked)
  const int* seg_kv;          // [B, T] or null
  int B, S, T, H, Hkv;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  int causal, causal_offset, window;
  float c;         // softmax_scale * log2(e)
  float sm_scale;  // softmax_scale
  Rotary rot;      // fused-rotary tables (kRot only)
};

__device__ __forceinline__ bool lse_dead(float lse) { return lse <= 0.5f * kNegInf; }

// dq for 64 query rows of one (batch, head); warp w owns rows 16w..16w+15.
template <int D, bool kRot>
__device__ __forceinline__ void bwd_dq(const BwdParams& p) {
  constexpr int kStride = D + 8, kKc = D / 16, kDn = D / 8;
  __shared__ __align__(16) __nv_bfloat16 k_s[kTile * kStride];
  __shared__ __align__(16) __nv_bfloat16 v_s[kTile * kStride];
  __shared__ int segkv_s[kTile];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int hk = h / (p.H / p.Hkv);
  const int q_lo = blockIdx.x * kTile;
  const int q_hi = min(q_lo + kTile, p.S) - 1;
  const int r0 = q_lo + warp * 16 + g, r1 = r0 + 8;
  const bool has_seg = p.seg_q != nullptr;
  const int w2 = p.window > 0 ? p.window / 2 : -1;

  const __nv_bfloat16* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + hk * p.v_sh;

  // q and dO fragments of this warp's rows stay in registers
  uint32_t qa[kKc][4], da[kKc][4];
  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  load_a_global<D>(qa, qb, p.q_ss, r0, p.S, t);
  load_a_global<D>(da, p.dout + b * p.o_sb + h * p.o_sh, p.o_ss, r0, p.S, t);
  const float* tcos = nullptr;
  const float* tsin = nullptr;
  if constexpr (kRot) {
    tcos = p.rot.cos + b * p.rot.sb;
    tsin = p.rot.sin + b * p.rot.sb;
    rotate_a<D>(qa, qb, p.q_ss, r0, p.S, t, tcos, tsin, p.rot);
  }
  const int64_t row0 = (int64_t(b) * p.H + h) * p.S;
  const float lse0 = r0 < p.S ? p.lse[row0 + r0] : kNegInf;
  const float lse1 = r1 < p.S ? p.lse[row0 + r1] : kNegInf;
  const float dl0 = r0 < p.S ? p.delta[row0 + r0] : 0.f;
  const float dl1 = r1 < p.S ? p.delta[row0 + r1] : 0.f;
  int sq0 = 0, sq1 = 0;
  if (has_seg) {
    if (r0 < p.S) sq0 = p.seg_q[b * p.S + r0];
    if (r1 < p.S) sq1 = p.seg_q[b * p.S + r1];
  }

  // kv tiles with any live column (dead tiles contribute exactly 0)
  int kv_begin = 0, kv_end = p.T;
  if (p.causal) kv_end = min(kv_end, q_hi + p.causal_offset + 1);
  if (w2 >= 0) {
    kv_begin = max(0, q_lo - w2);
    kv_end = min(kv_end, q_hi + w2 + 1);
  }
  kv_begin = kv_begin / kTile * kTile;

  float acc[kDn][4];
#pragma unroll
  for (int dn = 0; dn < kDn; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += kTile) {
    if constexpr (kRot)
      stage_pair_rot<D>(k_s, kb, p.k_ss, v_s, vb, p.v_ss, kv0, p.T, tid, tcos, tsin, p.rot);
    else
      stage_pair<D>(k_s, kb, p.k_ss, v_s, vb, p.v_ss, kv0, p.T, tid);
    if (has_seg && tid < kTile) {
      const int col = kv0 + tid;
      segkv_s[tid] = col < p.T ? p.seg_kv[b * p.T + col] : 0;
    }
    __syncthreads();

    float s[8][4], dp[8][4];
    gemm_abt<D>(s, qa, k_s, g, t);   // q k^T
    gemm_abt<D>(dp, da, v_s, g, t);  // dO v^T

    // ds = p * (dp - delta) * softmax_scale, written over s
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = nt * 8 + t * 2 + (e & 1);
        const int col = kv0 + cl;
        const bool top = e < 2;
        const int row = top ? r0 : r1;
        const float lse = top ? lse0 : lse1;
        bool ok = col < p.T && !lse_dead(lse) &&
                  in_band(row, col, p.causal, p.causal_offset, w2);
        if (has_seg) {
          const int skv = segkv_s[cl];
          ok = ok && (top ? sq0 : sq1) == skv && skv != 0;
        }
        const float pij = ok ? exp2f(fmaf(s[nt][e], p.c, -lse)) : 0.f;
        s[nt][e] = pij * (dp[nt][e] - (top ? dl0 : dl1)) * p.sm_scale;
      }
    }
    gemm_pb<D>(acc, s, k_s, g, t);  // dq += bf16(ds) k
    __syncthreads();                // the next tile overwrites k_s / v_s
  }

  if constexpr (kRot) rotate_adjoint<D>(acc, tcos, tsin, r0, t, p.rot);  // dq wrt the unrotated q
  const int64_t row_stride = int64_t(p.H) * D;
  store_rows<D>(p.dq + int64_t(b) * p.S * row_stride + int64_t(h) * D, row_stride, acc, r0,
                p.S, t);
}

// Shared memory of the dkv kernel: k, v, q and dO tiles, then the q tile's
// LSE, delta and segment ids.
template <int D>
constexpr int dkv_smem_bytes() {
  return 4 * kTile * (D + 8) * int(sizeof(__nv_bfloat16)) +
         kTile * int(2 * sizeof(float) + sizeof(int));
}

// dk, dv for 64 kv rows of one (batch, kv head); warp w owns kv rows
// 16w..16w+15. The loop covers every (q head of the GQA group, q tile)
// pair that has a live column.
template <int D, bool kRot>
__device__ __forceinline__ void bwd_dkv(const BwdParams& p) {
  constexpr int kStride = D + 8, kKc = D / 16, kDn = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_s = k_s + kTile * kStride;
  __nv_bfloat16* q_s = v_s + kTile * kStride;
  __nv_bfloat16* do_s = q_s + kTile * kStride;
  float* lse_s = reinterpret_cast<float*>(do_s + kTile * kStride);
  float* delta_s = lse_s + kTile;
  int* segq_s = reinterpret_cast<int*>(delta_s + kTile);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int group = p.H / p.Hkv;
  const int kv_lo = blockIdx.x * kTile;
  const int kv_hi = min(kv_lo + kTile, p.T) - 1;
  const int r0 = kv_lo + warp * 16 + g, r1 = r0 + 8;  // this thread's kv rows
  const bool has_seg = p.seg_q != nullptr;
  const int w2 = p.window > 0 ? p.window / 2 : -1;

  // the k/v tile is fixed for the whole loop; rows past T are zero
  const float* tcos = nullptr;
  const float* tsin = nullptr;
  if constexpr (kRot) {
    tcos = p.rot.cos + b * p.rot.sb;
    tsin = p.rot.sin + b * p.rot.sb;
    stage_pair_rot<D>(k_s, p.k + b * p.k_sb + hk * p.k_sh, p.k_ss, v_s,
                      p.v + b * p.v_sb + hk * p.v_sh, p.v_ss, kv_lo, p.T, tid, tcos, tsin, p.rot);
  } else {
    stage_pair<D>(k_s, p.k + b * p.k_sb + hk * p.k_sh, p.k_ss, v_s, p.v + b * p.v_sb + hk * p.v_sh,
                  p.v_ss, kv_lo, p.T, tid);
  }
  int skv0 = 0, skv1 = 0;
  if (has_seg) {
    if (r0 < p.T) skv0 = p.seg_kv[b * p.T + r0];
    if (r1 < p.T) skv1 = p.seg_kv[b * p.T + r1];
  }

  // q tiles with any live row for this kv tile
  int q_begin = 0, q_end = p.S;
  if (p.causal) q_begin = max(0, kv_lo - p.causal_offset);
  if (w2 >= 0) {
    q_begin = max(q_begin, kv_lo - w2);
    q_end = min(q_end, kv_hi + w2 + 1);
  }
  q_begin = q_begin / kTile * kTile;

  float dk[kDn][4], dv[kDn][4];
#pragma unroll
  for (int dn = 0; dn < kDn; ++dn) {
    dk[dn][0] = dk[dn][1] = dk[dn][2] = dk[dn][3] = 0.f;
    dv[dn][0] = dv[dn][1] = dv[dn][2] = dv[dn][3] = 0.f;
  }

  for (int m = 0; m < group; ++m) {
    const int h = hk * group + m;
    const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* ob = p.dout + b * p.o_sb + h * p.o_sh;
    const int64_t row0 = (int64_t(b) * p.H + h) * p.S;
    for (int q0 = q_begin; q0 < q_end; q0 += kTile) {
      if constexpr (kRot)
        stage_pair_rot<D>(q_s, qb, p.q_ss, do_s, ob, p.o_ss, q0, p.S, tid, tcos, tsin, p.rot);
      else
        stage_pair<D>(q_s, qb, p.q_ss, do_s, ob, p.o_ss, q0, p.S, tid);
      if (tid < kTile) {
        const int qr = q0 + tid;
        lse_s[tid] = qr < p.S ? p.lse[row0 + qr] : kNegInf;  // rows past S are dead
        delta_s[tid] = qr < p.S ? p.delta[row0 + qr] : 0.f;
        if (has_seg) segq_s[tid] = qr < p.S ? p.seg_q[b * p.S + qr] : 0;
      }
      __syncthreads();

      // transposed products: rows are this warp's kv rows, columns q rows
      uint32_t a[kKc][4];
      float st[8][4], dpt[8][4];
      load_a_shared<D>(a, k_s, warp * 16, g, t);
      gemm_abt<D>(st, a, q_s, g, t);    // (q k^T)^T
      load_a_shared<D>(a, v_s, warp * 16, g, t);
      gemm_abt<D>(dpt, a, do_s, g, t);  // (dO v^T)^T

      // p^T over st, ds^T over dpt
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cl = nt * 8 + t * 2 + (e & 1);
          const int qr = q0 + cl;
          const bool top = e < 2;
          const int kvr = top ? r0 : r1;
          const float lse = lse_s[cl];
          bool ok = kvr < p.T && !lse_dead(lse) &&
                    in_band(qr, kvr, p.causal, p.causal_offset, w2);
          if (has_seg) {
            const int skv = top ? skv0 : skv1;
            ok = ok && segq_s[cl] == skv && skv != 0;
          }
          const float pij = ok ? exp2f(fmaf(st[nt][e], p.c, -lse)) : 0.f;
          st[nt][e] = pij;
          dpt[nt][e] = pij * (dpt[nt][e] - delta_s[cl]) * p.sm_scale;
        }
      }
      gemm_pb<D>(dv, st, do_s, g, t);  // dv += bf16(p)^T dO
      gemm_pb<D>(dk, dpt, q_s, g, t);  // dk += bf16(ds)^T q
      __syncthreads();                 // the next step overwrites q_s / do_s
    }
  }

  const int64_t row_stride = int64_t(p.Hkv) * D;
  const int64_t base = int64_t(b) * p.T * row_stride + int64_t(hk) * D;
  store_rows<D>(p.dv + base, row_stride, dv, r0, p.T, t);
  if constexpr (kRot) rotate_adjoint<D>(dk, tcos, tsin, r0, t, p.rot);  // dk wrt the unrotated k
  store_rows<D>(p.dk + base, row_stride, dk, r0, p.T, t);
}

// The kernels. The fused-rotary ones at D = 64 are held to three blocks per
// SM, which 128-thread blocks reach at <= 170 registers a thread: left
// free, the fused dk/dv kernel took 176 and fit two blocks per SM, 1.8x
// slower than the unfused one at the MLM shape (PERF.md, PR 4). The plain
// ones keep the compiler's choice (a stated minimum of 1 block moved the
// plain dk/dv kernel from 167 to 204 registers, two blocks per SM).
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const BwdParams p) {
  bwd_dq<D, false>(p);
}

template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 3 : 1) flash_bwd_dq_rot_kernel(const BwdParams p) {
  bwd_dq<D, true>(p);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const BwdParams p) {
  bwd_dkv<D, false>(p);
}

template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 3 : 1) flash_bwd_dkv_rot_kernel(const BwdParams p) {
  bwd_dkv<D, true>(p);
}

BwdParams make_params(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* seg_q, const void* seg_kv,
                      int B, int S, int T, int H, int Hkv, const int64_t (&st)[12], int causal,
                      int causal_offset, int window, float c, float sm_scale, const void* rot_cos,
                      const void* rot_sin, int64_t rot_sb, int rot_half, int rot_interleaved) {
  BwdParams p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_kv = static_cast<const int*>(seg_kv);
  p.B = B; p.S = S; p.T = T; p.H = H; p.Hkv = Hkv;
  p.q_sb = st[0]; p.q_ss = st[1]; p.q_sh = st[2];
  p.k_sb = st[3]; p.k_ss = st[4]; p.k_sh = st[5];
  p.v_sb = st[6]; p.v_ss = st[7]; p.v_sh = st[8];
  p.o_sb = st[9]; p.o_ss = st[10]; p.o_sh = st[11];
  p.causal = causal; p.causal_offset = causal_offset; p.window = window;
  p.c = c;
  p.sm_scale = sm_scale;
  p.rot = Rotary{static_cast<const float*>(rot_cos), static_cast<const float*>(rot_sin), rot_sb,
                 rot_half, rot_interleaved};
  return p;
}

template <int D, bool kRot>
cudaError_t launch_dkv(const BwdParams& p, cudaStream_t st) {
  constexpr int bytes = dkv_smem_bytes<D>();
  void (*kernel)(BwdParams) = kRot ? flash_bwd_dkv_rot_kernel<D> : flash_bwd_dkv_kernel<D>;
  // above 48 KB (D = 128) dynamic shared memory must be allowed explicitly
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + kTile - 1) / kTile, p.Hkv, p.B);
  kernel<<<grid, kThreads, bytes, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// C entry points, loaded with ctypes. Each launches on `stream`, does not
// synchronise and allocates nothing; each returns cudaGetLastError() so the
// caller sees a refused launch (bad shape, too many resources) at once.
// rot_cos == NULL runs the plain variant; otherwise the fused-rotary one,
// with the tables and rules of flash_fwd_bf16 (S == T, rot_half % 8 == 0).
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, const void* seg_q,
                                 const void* seg_kv, int B, int S, int T, int H, int Hkv, int D,
                                 int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                                 int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                                 int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
                                 int causal, int causal_offset, int window, float c,
                                 float sm_scale, const void* rot_cos, const void* rot_sin,
                                 int64_t rot_sb, int rot_half, int rot_interleaved, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || !rot_ok(rot_cos, rot_half, D)) return int(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || H == 0) return int(cudaSuccess);
  const int64_t st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  BwdParams p = make_params(q, k, v, dout, lse, delta, seg_q, seg_kv, B, S, T, H, Hkv, st,
                            causal, causal_offset, window, c, sm_scale, rot_cos, rot_sin, rot_sb,
                            rot_half, rot_interleaved);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fused = rot_cos != nullptr;
  if (D == 64) {
    if (fused) flash_bwd_dq_rot_kernel<64><<<grid, kThreads, 0, s>>>(p);
    else flash_bwd_dq_kernel<64><<<grid, kThreads, 0, s>>>(p);
  } else if (D == 128) {
    if (fused) flash_bwd_dq_rot_kernel<128><<<grid, kThreads, 0, s>>>(p);
    else flash_bwd_dq_kernel<128><<<grid, kThreads, 0, s>>>(p);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv,
                                  const void* seg_q, const void* seg_kv, int B, int S, int T,
                                  int H, int Hkv, int D, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                                  int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                                  int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss,
                                  int64_t o_sh, int causal, int causal_offset, int window,
                                  float c, float sm_scale, const void* rot_cos,
                                  const void* rot_sin, int64_t rot_sb, int rot_half,
                                  int rot_interleaved, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || !rot_ok(rot_cos, rot_half, D)) return int(cudaErrorInvalidValue);
  // S == 0 still runs: every kv row then gets dk = dv = 0
  if (B == 0 || T == 0 || Hkv == 0) return int(cudaSuccess);
  const int64_t st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  BwdParams p = make_params(q, k, v, dout, lse, delta, seg_q, seg_kv, B, S, T, H, Hkv, st,
                            causal, causal_offset, window, c, sm_scale, rot_cos, rot_sin, rot_sb,
                            rot_half, rot_interleaved);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fused = rot_cos != nullptr;
  if (D == 64) return int(fused ? launch_dkv<64, true>(p, s) : launch_dkv<64, false>(p, s));
  if (D == 128) return int(fused ? launch_dkv<128, true>(p, s) : launch_dkv<128, false>(p, s));
  return int(cudaErrorInvalidValue);
}
