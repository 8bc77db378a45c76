// Flash-attention forward for Hopper (sm_90a): bf16 q/k/v/O, fp32 LSE.
//
// Replaces the two Pallas TPU forward kernels of
// contrastors_tpu/ops/flash_attention.py:
//   _fwd_kernel_single (:225) - the whole kv range in one block (T <= 2048),
//   _fwd_kernel        (:115) - multi-block FA-2 online softmax (T > 2048).
// One design covers both. A block owns 64 query rows of one (batch, head)
// and loops over 64-wide kv tiles with an online softmax held in fp32
// registers; when T fits one tile the loop runs once. The TPU's single-block
// special case existed to fit VMEM and needs no kernel of its own here.
//
// What bounds it on an H100: per (batch, head) the work is 4*S*T*D FLOP
// against 8*S*D bytes of q, k, v and O (S == T), i.e. T/2 FLOP per byte.
// That is ~256 at the encode length T=512, just under the card's ~295
// FLOP/byte balance point for bf16, so the function is bound by bytes at
// T <= 512 and by tensor-core operations above it. The design keeps S and P
// out of device memory (registers only), reads each q row once and each k/v
// tile once per q tile through shared memory, masks ragged edges in-kernel
// (no padding to 128, no [B,H,S,D] transposes: q/k/v arrive strided in the
// [B,S,H,D] layout, e.g. as views of the fused Wqkv output), and runs both
// products on bf16 tensor cores (mma.sync m16n8k16, fp32 accumulation).
// It is the simple first design: no wgmma, TMA, cp.async pipelining or warp
// specialisation, so it is expected to stay well short of both bounds.
//
// Fused rotary (template flag kRot; the JAX kernels' fused_rot=True, and the
// ablation script's prototype _fused_fwd_kernel,
// scripts/ablate_rotary_fusion.py:42): q fragments are rotated as they are
// read into registers and each k tile as it is staged into shared memory,
// in fp32 with one bf16 cast (flash_common.cuh, Rotary), so q and k never
// make the round trip through device memory that an outside rotation costs
// (a read and a write of each). The price: each k tile is rotated again for
// every q tile that meets it, with 2*64*D*4 bytes of fp32 table reads per
// staged tile (through L1/L2); at the MLM shape the fused kernel takes 1.45x
// the time of the unfused one, still less than rotating outside (PERF.md).
//
// Semantics follow the JAX kernels exactly:
//   s = q.k^T in fp32, unscaled; c = softmax_scale*log2(e) enters only as
//   p = exp2(s*c - m*c); the row max is floored at -1e20/c so a fully masked
//   tile gives p == 0; p is cast to bf16 for the PV product;
//   masks: seg_q == seg_kv != 0, bottom-right causal row + off >= col,
//   window |row - col| <= window/2; GQA kv head = h / (H / Hkv);
//   O = acc / l (0 where l == 0), LSE = m*c + log2(l) (-1e30 where l == 0).

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBlockM = kTile;  // q rows per block: 4 warps x 16 rows
constexpr int kBlockN = kTile;  // kv rows per tile

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;  // [B, S, H, D] contiguous
  float* lse;        // [B, H, S]
  const int* seg_q;  // [B, S] or null (unmasked)
  const int* seg_kv; // [B, T] or null
  int B, S, T, H, Hkv;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int causal, causal_offset, window;
  float c;  // softmax_scale * log2(e)
  Rotary rot;  // fused-rotary tables (kRot only)
};

// The fragment layout is described in flash_common.cuh.
template <int D, bool kRot>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  constexpr int kStride = D + 8;  // padded smem row: conflict-free fragment reads
  constexpr int kKc = D / 16;     // k-steps of the QK^T product
  constexpr int kDn = D / 8;      // n-tiles of the PV product
  constexpr int kChunks = D / 8;  // 16-byte chunks per k/v row
  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockN * kStride];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBlockN * kStride];
  __shared__ int segkv_s[kBlockN];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int hk = h / (p.H / p.Hkv);
  const int q_lo = blockIdx.x * kBlockM;
  const int q_hi = min(q_lo + kBlockM, p.S) - 1;
  const int r0 = q_lo + warp * 16 + g, r1 = r0 + 8;
  const bool has_seg = p.seg_q != nullptr;
  const int w2 = p.window / 2;

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + hk * p.v_sh;

  // q fragments stay in registers for the whole kv loop
  uint32_t qa[kKc][4];
#pragma unroll
  for (int kc = 0; kc < kKc; ++kc) {
    const int col = kc * 16 + t * 2;
    qa[kc][0] = r0 < p.S ? ld32(qb + r0 * p.q_ss + col) : 0u;
    qa[kc][1] = r1 < p.S ? ld32(qb + r1 * p.q_ss + col) : 0u;
    qa[kc][2] = r0 < p.S ? ld32(qb + r0 * p.q_ss + col + 8) : 0u;
    qa[kc][3] = r1 < p.S ? ld32(qb + r1 * p.q_ss + col + 8) : 0u;
  }
  const float* tcos = nullptr;
  const float* tsin = nullptr;
  if constexpr (kRot) {
    tcos = p.rot.cos + b * p.rot.sb;
    tsin = p.rot.sin + b * p.rot.sb;
    rotate_a<D>(qa, qb, p.q_ss, r0, p.S, t, tcos, tsin, p.rot);
  }
  int sq0 = 0, sq1 = 0;
  if (has_seg) {
    if (r0 < p.S) sq0 = p.seg_q[b * p.S + r0];
    if (r1 < p.S) sq1 = p.seg_q[b * p.S + r1];
  }

  // kv tiles that causal / window leave any live column in (the JAX kernel
  // skips the same dead blocks; skipping them is exact)
  int kv_begin = 0, kv_end = p.T;
  if (p.causal) kv_end = min(kv_end, q_hi + p.causal_offset + 1);
  if (p.window > 0) {
    kv_begin = max(0, q_lo - w2);
    kv_end = min(kv_end, q_hi + w2 + 1);
  }
  kv_begin = kv_begin / kBlockN * kBlockN;

  const float c = p.c;
  const float m_floor = -1e20f / c;
  float m_i[2] = {kNegInf, kNegInf};
  float l_i[2] = {0.f, 0.f};  // per-thread partial row sums
  float acc[kDn][4];
#pragma unroll
  for (int dn = 0; dn < kDn; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += kBlockN) {
    // stage the k/v tile; rows past T are zero so that p == 0 meets finite v
    for (int i = tid; i < kBlockN * kChunks; i += kThreads) {
      const int row = i / kChunks, ch = i % kChunks;
      const int col = kv0 + row;
      uint4 kval = make_uint4(0u, 0u, 0u, 0u), vval = kval;
      if (col < p.T) {
        kval = *reinterpret_cast<const uint4*>(kb + col * p.k_ss + ch * 8);
        vval = *reinterpret_cast<const uint4*>(vb + col * p.v_ss + ch * 8);
        if constexpr (kRot)
          kval = rotate_chunk(kval, kb + col * p.k_ss, tcos + col * D, tsin + col * D, ch * 8, p.rot);
      }
      *reinterpret_cast<uint4*>(&k_s[row * kStride + ch * 8]) = kval;
      *reinterpret_cast<uint4*>(&v_s[row * kStride + ch * 8]) = vval;
    }
    if (has_seg && tid < kBlockN) {
      const int col = kv0 + tid;
      segkv_s[tid] = col < p.T ? p.seg_kv[b * p.T + col] : 0;
    }
    __syncthreads();

    // s = q k^T for this warp's 16 rows x 64 columns
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = &k_s[(nt * 8 + g) * kStride + t * 2];
#pragma unroll
      for (int kc = 0; kc < kKc; ++kc) {
        mma_16816(s[nt], qa[kc], ld32(kr + kc * 16), ld32(kr + kc * 16 + 8));
      }
    }

    // masks: ragged tail, segments, causal, window
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = nt * 8 + t * 2 + (e & 1);
        const int col = kv0 + cl;
        const int row = e < 2 ? r0 : r1;
        bool ok = col < p.T;
        if (has_seg) {
          const int skv = segkv_s[cl];
          ok = ok && (e < 2 ? sq0 : sq1) == skv && skv != 0;
        }
        if (p.causal) ok = ok && row + p.causal_offset >= col;
        if (p.window > 0) ok = ok && abs(row - col) <= w2;
        if (!ok) s[nt][e] = kNegInf;
      }
    }

    // online softmax over the tile
    float mx0 = m_i[0], mx1 = m_i[1];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(quad_max(mx0), m_floor);
    mx1 = fmaxf(quad_max(mx1), m_floor);
    const float corr0 = exp2f((m_i[0] - mx0) * c);
    const float corr1 = exp2f((m_i[1] - mx1) * c);
    const float mc0 = mx0 * c, mc1 = mx1 * c;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = exp2f(fmaf(s[nt][0], c, -mc0));
      s[nt][1] = exp2f(fmaf(s[nt][1], c, -mc0));
      s[nt][2] = exp2f(fmaf(s[nt][2], c, -mc1));
      s[nt][3] = exp2f(fmaf(s[nt][3], c, -mc1));
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
    l_i[0] = l_i[0] * corr0 + sum0;
    l_i[1] = l_i[1] * corr1 + sum1;
    m_i[0] = mx0;
    m_i[1] = mx1;
#pragma unroll
    for (int dn = 0; dn < kDn; ++dn) {
      acc[dn][0] *= corr0;
      acc[dn][1] *= corr0;
      acc[dn][2] *= corr1;
      acc[dn][3] *= corr1;
    }

    // acc += bf16(p) v: the C fragments of two adjacent s n-tiles are the
    // A fragment of one 16-deep k-step
    const uint16_t* vs = reinterpret_cast<const uint16_t*>(v_s);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const uint16_t* vr = vs + (kk * 16 + t * 2) * kStride + g;
#pragma unroll
      for (int dn = 0; dn < kDn; ++dn) {
        const uint16_t* x = vr + dn * 8;
        const uint32_t b0 = uint32_t(x[0]) | (uint32_t(x[kStride]) << 16);
        const uint32_t b1 = uint32_t(x[8 * kStride]) | (uint32_t(x[9 * kStride]) << 16);
        mma_16816(acc[dn], a, b0, b1);
      }
    }
    __syncthreads();  // the next tile overwrites k_s / v_s
  }

  const float l0 = quad_sum(l_i[0]), l1 = quad_sum(l_i[1]);
  const float ls0 = l0 == 0.f ? 1.f : l0, ls1 = l1 == 0.f ? 1.f : l1;
  const int64_t row_stride = int64_t(p.H) * D;
  if (r0 < p.S) {
    __nv_bfloat16* orow = p.o + (int64_t(b) * p.S + r0) * row_stride + int64_t(h) * D + t * 2;
#pragma unroll
    for (int dn = 0; dn < kDn; ++dn)
      *reinterpret_cast<uint32_t*>(orow + dn * 8) = pack_bf16(acc[dn][0] / ls0, acc[dn][1] / ls0);
    if (t == 0)
      p.lse[(int64_t(b) * p.H + h) * p.S + r0] = l0 == 0.f ? kNegInf : m_i[0] * c + log2f(ls0);
  }
  if (r1 < p.S) {
    __nv_bfloat16* orow = p.o + (int64_t(b) * p.S + r1) * row_stride + int64_t(h) * D + t * 2;
#pragma unroll
    for (int dn = 0; dn < kDn; ++dn)
      *reinterpret_cast<uint32_t*>(orow + dn * 8) = pack_bf16(acc[dn][2] / ls1, acc[dn][3] / ls1);
    if (t == 0)
      p.lse[(int64_t(b) * p.H + h) * p.S + r1] = l1 == 0.f ? kNegInf : m_i[1] * c + log2f(ls1);
  }
}

}  // namespace

// C entry point, loaded with ctypes. Launches on `stream`, does not
// synchronise and allocates nothing; returns cudaGetLastError() so the caller
// sees a refused launch (bad shape, too many resources) at once. rot_cos ==
// NULL runs the plain variant; otherwise q and k are rotated with the fp32
// tables (rows of D, at least round_up(S, 64) of them, batch stride rot_sb),
// rot_half = rot_dim / 2 a multiple of 8, and S must equal T.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                              const void* seg_q, const void* seg_kv, int B, int S, int T, int H,
                              int Hkv, int D, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                              int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                              int64_t v_ss, int64_t v_sh, int causal, int causal_offset,
                              int window, float c, const void* rot_cos, const void* rot_sin,
                              int64_t rot_sb, int rot_half, int rot_interleaved, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || !rot_ok(rot_cos, rot_half, D)) return int(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || H == 0) return int(cudaSuccess);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_kv = static_cast<const int*>(seg_kv);
  p.B = B; p.S = S; p.T = T; p.H = H; p.Hkv = Hkv;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.causal = causal; p.causal_offset = causal_offset; p.window = window;
  p.c = c;
  p.rot = Rotary{static_cast<const float*>(rot_cos), static_cast<const float*>(rot_sin), rot_sb,
                 rot_half, rot_interleaved};
  const bool fused = rot_cos != nullptr;
  const dim3 grid((S + kBlockM - 1) / kBlockM, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    if (fused) flash_fwd_kernel<64, true><<<grid, kThreads, 0, st>>>(p);
    else flash_fwd_kernel<64, false><<<grid, kThreads, 0, st>>>(p);
  } else if (D == 128) {
    if (fused) flash_fwd_kernel<128, true><<<grid, kThreads, 0, st>>>(p);
    else flash_fwd_kernel<128, false><<<grid, kThreads, 0, st>>>(p);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
