// Flash attention forward and backward in bf16 at every head dim the Pallas
// kernels take that the Hopper kernels (flash_fwd.cu, flash_bwd.cu: D = 64 or
// 128, TMA-aligned) do not: D % 8 == 0 with D <= 256, fp32 LSE. The fp32
// kernels are in flash_tf32.cu; what the two files share (arguments, masks,
// rotary, ranges, copies, and the semantics) is in flash_generic_common.cuh.
//
// Replaces, for those inputs, the Pallas TPU kernels of
// contrastors_tpu/ops/flash_attention.py:
//   flash_generic_fwd - _fwd_kernel_single (:225) and _fwd_kernel (:115),
//   flash_generic_dq  - _bwd_dq_kernel (:422),
//   flash_generic_dkv - _bwd_dkv_kernel (:512),
// with their fused_rot=True forms (_rot_block :76, _rot_adjoint :87) as a
// run-time choice: a NULL cos table means no rotary. The Pallas kernels take
// their scratch and output dtypes from q (:395, :405); so do these (bf16
// outputs, fp32 accumulators and statistics).
//
// All three run on the tensor cores (mma.sync.m16n8k16 over bf16 tiles); the
// notes of each kernel below say what bounds it and what its design does
// about that.

#include "flash_generic_common.cuh"

namespace {

// ---- bf16 on the tensor cores: the forward and dk/dv ---------------------------
//
// fwd_tc_kernel and dkv_tc_kernel replace, for bf16, the Pallas kernels named
// at the top of this file: the forward _fwd_kernel_single (:225) /
// _fwd_kernel (:115), call :396, with fused_rot (_rot_block :76); dk/dv
// _bwd_dkv_kernel (:512), call :700, adjoint :600-604. dq has its own kernel
// and note further down.
//
// What bounds them on an H100: bytes at the main path's shapes (64 x 257 at
// D 80 / 88, pythia-1b's 128-token rows at D 256: a few hundred FLOP per byte
// at most, under the card's ~295), then the softmax's exp2 and masking in
// registers, which a tensor core does not run. A first design of fp32 FMAs
// over operands widened to fp32 in shared memory reached neither.
//
// What the design does about it (FlashAttention-2's shape on mma.sync):
//   - operands stay bf16 in shared memory, each tile zero-padded from D to
//     its bucket's width DMAX (64, 96, 128, 192, 256: a template parameter,
//     so that every loop over D unrolls at compile time) in rows of DMAX + 8
//     elements: an odd multiple of 16 bytes, so the eight rows an ldmatrix
//     reads fall in eight distinct 16-byte bank groups;
//   - tiles arrive by cp.async, 16 bytes a thread, while the previous product
//     runs; an operand whose address or strides are not 16-byte aligned
//     (a.vec == 0), or a q / k tile that is rotated on load, is staged through
//     registers instead (rotation in fp32, rounded to bf16 as the plain
//     version rounds);
//   - products are mma.sync.m16n8k16 (bf16 in, fp32 accumulate), operands by
//     ldmatrix (.trans for the [k][n] tiles);
//   - forward: 4 warps, 16 query rows each, 64 rows a block; S = Q K^T, the
//     online softmax in registers, p cast to bf16 against the running max and
//     fed to P V straight from the accumulator registers. At D <= 128 two
//     K / V stages: the next tile's copies run under this tile's work; above,
//     where two stages would leave one block a SM, one K and one V buffer:
//     V's copy runs under Q K^T, the next K's under P V;
//   - dk/dv: 8 warps own 64 kv rows of one (batch, kv head) and walk the
//     64-row q tiles of every q head of the group, double-buffered. Warp (w %
//     4, w / 4) computes a 16 x 32 block of S and dP, recomputes p from the
//     LSE and writes p and ds as bf16 to shared memory; then warp (w % 4,
//     w / 4) accumulates dV += P^T dO and dK += dS^T Q for 16 kv rows and
//     every other 16 columns of D in fp32 registers (at D = 256, 128 a
//     thread). The rotary adjoint goes through shared memory (store_adjoint).
// Dead kv tiles (forward) and q tiles (dk/dv) are skipped; a tile is masked
// element by element only where a mask can cut it. Every output element has
// one owner and a fixed order of sums: no atomics, bit-identical reruns.

typedef __nv_bfloat16 bf16;
constexpr int kTc = 64;             // rows of every bf16 tile
constexpr int kFwdTcThreads = 128;  // 4 warps x 16 query rows
constexpr int kDkvTcThreads = 256;  // 8 warps
constexpr int kPld = kTc + 8;       // row stride of the p / ds tiles (elements)

// a sum over the 16 threads of a row group (lanes 0-15 or 16-31)
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ROWS rows row0 .. of one (batch, head) of x (row stride ss) into dst (row
// stride ld elements), columns [0, D); rows past n_valid are zero. By
// cp.async when `async` (16-byte aligned rows), else staged through
// registers, rotated (q, k) as the plain version rotates when `rotate`.
template <int NT, int DMAX, int ROWS = kTc>
__device__ __forceinline__ void tile_load(bf16* dst, int ld, const bf16* base, int64_t ss, int row0, int n_valid,
                                          int D, bool async, bool rotate, const Rot& rot, int b) {
  if (async && !rotate) {
    constexpr int SLOTS = DMAX / 8;  // 16-byte slots of a row, D / 8 of them used
    static_assert(ROWS * SLOTS % NT == 0, "every thread issues the same number of copies");
#pragma unroll
    for (int it = 0; it < ROWS * SLOTS / NT; ++it) {
      const int idx = threadIdx.x + it * NT, r = idx / SLOTS, c = idx % SLOTS, pos = row0 + r;
      if (c < (D >> 3)) {
        const bool ok = pos < n_valid;
        cp_async16(smem_addr(dst + r * ld + c * 8), ok ? base + int64_t(pos) * ss + c * 8 : base, ok);
      }
    }
    return;
  }
  for (int idx = threadIdx.x; idx < ROWS * D; idx += NT) {
    const int r = idx / D, d = idx - r * D, pos = row0 + r;
    float x = 0.f;
    if (pos < n_valid) {
      const bf16* row = base + pos * ss;
      x = __bfloat162float(row[d]);
      if (rotate && d < 2 * rot.half) {
        const int64_t t = b * rot.sb + int64_t(pos) * D + d;
        const float xp = rot_sign(d, rot) * __bfloat162float(row[partner(d, rot)]);
        x = __fadd_rn(__fmul_rn(x, rot.cos[t]), __fmul_rn(xp, rot.sin[t]));
      }
    }
    dst[r * ld + d] = __float2bfloat16_rn(x);
  }
}

// zero columns [D, DMAX) of `n_tiles` consecutive kTc-row tiles of row
// stride DMAX + 8; no load writes them
template <int NT, int DMAX>
__device__ __forceinline__ void zero_pad_columns(bf16* tiles, int n_tiles, int D) {
  const int pad = (DMAX - D) >> 3;  // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < n_tiles * kTc * pad; idx += NT) {
    const int r = idx / pad, c = idx - r * pad;
    *reinterpret_cast<uint4*>(tiles + r * (DMAX + 8) + D + c * 8) = make_uint4(0, 0, 0, 0);
  }
}


// K / V stages of the forward: two (the next tile's copies run under the
// whole of this tile's work) where they fit beside 2-3 blocks a SM; one at
// D > 128, where V's copy runs under Q K^T and the next K's under P V
template <int DMAX>
constexpr int kFwdStages = DMAX > 128 ? 1 : 2;

template <int DMAX>
size_t fwd_tc_bytes() {
  return size_t(1 + 2 * kFwdStages<DMAX>) * kTc * (DMAX + 8) * sizeof(bf16) +
         (1 + kFwdStages<DMAX>) * kTc * sizeof(int);
}

template <int DMAX>
__global__ void __launch_bounds__(kFwdTcThreads, DMAX > 96 ? 2 : 3) fwd_tc_kernel(Args a) {
  constexpr int NT = DMAX / 8, KS = DMAX / 16, ST = kFwdStages<DMAX>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int ld = DMAX + 8;
  const int D = a.D;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [kTc][ld]; after the walk, O in bf16
  bf16* sK = sQ + kTc * ld;                       // [ST][kTc][ld]
  bf16* sV = sK + ST * kTc * ld;                  // [ST][kTc][ld]
  int* sq = reinterpret_cast<int*>(sV + ST * kTc * ld);  // [kTc]
  int* skv = sq + kTc;                                   // [ST][kTc]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int n_qt = (a.S + kTc - 1) / kTc;
  const int qt = blockIdx.x % n_qt, h = (blockIdx.x / n_qt) % a.H, b = blockIdx.x / (n_qt * a.H);
  const int hk = h / (a.H / a.Hkv), q0 = qt * kTc;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const bool rot = a.rot.cos != nullptr, vec = a.vec != 0;
  auto load_k = [&](int c, int st) {
    tile_load<kFwdTcThreads, DMAX>(sK + st * kTc * ld, ld, kb, a.k_ss, c, a.T, D, vec, rot, a.rot, b);
    if (a.seg_kv != nullptr && tid < kTc)
      skv[st * kTc + tid] = c + tid < a.T ? a.seg_kv[int64_t(b) * a.T + c + tid] : 0;
  };
  auto load_v = [&](int c, int st) {
    tile_load<kFwdTcThreads, DMAX>(sV + st * kTc * ld, ld, vb, a.v_ss, c, a.T, D, vec, false, a.rot, b);
  };

  zero_pad_columns<kFwdTcThreads, DMAX>(sQ, 1 + 2 * ST, D);
  tile_load<kFwdTcThreads, DMAX>(sQ, ld, qb, a.q_ss, q0, a.S, D, vec, rot, a.rot, b);
  if (a.seg_q != nullptr && tid < kTc) sq[tid] = q0 + tid < a.S ? a.seg_q[int64_t(b) * a.S + q0 + tid] : 0;
  int lo, hi;
  kv_range(a, q0, min(q0 + kTc, a.S) - 1, lo, hi);
  const int first = lo / kTc * kTc;
  if (first < hi) {
    load_k(first, 0);
    if (ST == 2) load_v(first, 0);
  }
  cp_commit();

  float o[NT][4], m[2], l[2];
  const float floor_m = -1e20f / a.c;
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  m[0] = m[1] = floor_m;
  l[0] = l[1] = 0.f;
  const int rl0 = warp * 16 + g;  // this thread's rows rl0 and rl0 + 8 of the tile
  const uint32_t q_addr = smem_addr(sQ + (warp * 16 + a_row(lane)) * ld + a_col(lane));
  const uint32_t k_addr = smem_addr(sK + bn_row(lane) * ld + bn_col(lane));
  const uint32_t v_addr = smem_addr(sV + bk_row(lane) * ld + bk_col(lane));
  constexpr uint32_t stage_bytes = kTc * ld * 2;
  uint32_t pa[4][4];  // p in bf16 as the A fragments of P V, kv 16 kk .. 16 kk + 15

  // S = Q K^T of the tile at c0 in stage st, masked, the online softmax, p into pa
  auto scores = [&](int c0, int st) {
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4];
      ldsm4(qa, q_addr + kk * 32);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4];
        ldsm4(kf, k_addr + st * stage_bytes + (np * 16 * ld + kk * 16) * 2);
        mma_bf16(s[2 * np], qa, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
      }
    }
    if (tile_masked(a, q0, c0)) {
      const int* skv_t = skv + st * kTc;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rl = rl0 + (e >> 1) * 8, cl = j * 8 + 2 * t4 + (e & 1);
          if (!valid(a, q0 + rl, c0 + cl, a.seg_q ? sq[rl] : 0, a.seg_kv ? skv_t[cl] : 0)) s[j][e] = kNegInf;
        }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      const float mc = __fmul_rn(m_new, a.c), alpha = exp2f(__fmul_rn(m[hr], a.c) - mc);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
          s[j][e] = exp2f(__fmul_rn(s[j][e], a.c) - mc);
          sum += s[j][e];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[hr] = l[hr] * alpha + sum;
      m[hr] = m_new;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][2 * hr] *= alpha;
        o[n][2 * hr + 1] *= alpha;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
  };
  // O += P V with V in stage st
  auto pv = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t vf[4];
        ldsm4_t(vf, v_addr + st * stage_bytes + (kk * 16 * ld + np * 16) * 2);
        mma_bf16(o[2 * np], pa[kk], vf[0], vf[1]);
        mma_bf16(o[2 * np + 1], pa[kk], vf[2], vf[3]);
      }
  };

  if (ST == 2) {
    for (int c0 = first, st = 0; c0 < hi; c0 += kTc, st ^= 1) {
      if (c0 + kTc < hi) {
        load_k(c0 + kTc, st ^ 1);
        load_v(c0 + kTc, st ^ 1);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();  // stage st (and Q) landed
      scores(c0, st);
      pv(st);
      __syncthreads();  // every warp is done with stage st before it is refilled
    }
  } else {
    for (int c0 = first; c0 < hi; c0 += kTc) {
      cp_wait<0>();
      __syncthreads();  // K (and Q) landed; every warp is done with V
      load_v(c0, 0);
      cp_commit();
      scores(c0, 0);
      cp_wait<0>();
      __syncthreads();  // V landed; every warp is done with K and skv
      if (c0 + kTc < hi) load_k(c0 + kTc, 0);
      cp_commit();
      pv(0);
    }
  }
  cp_wait<0>();
  __syncthreads();  // no copy into sQ is in flight (a block with no live kv tile)
  // O = acc / l (0 on dead rows) into this warp's own rows of sQ, then 16-byte stores
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int rl = rl0 + hr * 8, r = q0 + rl;
    const bool dead = l[hr] == 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(sQ + rl * ld + n * 8 + 2 * t4) =
          dead ? 0u : pack_bf16(o[n][2 * hr] / l[hr], o[n][2 * hr + 1] / l[hr]);
    if (t4 == 0 && r < a.S)
      a.lse[(int64_t(b) * a.H + h) * a.S + r] = dead ? kNegInf : __fmul_rn(m[hr], a.c) + log2f(l[hr]);
  }
  __syncwarp();
  bf16* out = static_cast<bf16*>(a.out);
  const int chunks = D >> 3;
  for (int idx = lane; idx < 16 * chunks; idx += 32) {
    const int rl = warp * 16 + idx / chunks, c = idx % chunks, r = q0 + rl;
    if (r < a.S)
      *reinterpret_cast<uint4*>(out + ((int64_t(b) * a.S + r) * a.H + h) * D + c * 8) =
          *reinterpret_cast<const uint4*>(sQ + rl * ld + c * 8);
  }
}

template <int DMAX>
size_t dkv_tc_bytes() {
  return size_t(6) * kTc * (DMAX + 8) * sizeof(bf16) + size_t(2) * kTc * kPld * sizeof(bf16) + 7 * kTc * sizeof(float);
}

template <int DMAX>
__global__ void __launch_bounds__(kDkvTcThreads, DMAX > 128 ? 1 : 2) dkv_tc_kernel(Args a) {
  constexpr int KS = DMAX / 16, NP = DMAX / 32;  // k-steps over D; 16-column pairs of D a warp owns
  static_assert(DMAX % 32 == 0, "the two column halves of phase 2 own DMAX / 32 pairs each");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int ld = DMAX + 8;
  const int D = a.D;
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [kTc][ld]
  bf16* sV = sK + kTc * ld;
  bf16* sQ = sV + kTc * ld;     // [2][kTc][ld]; after the walk, dk in fp32 (rotary)
  bf16* sdO = sQ + 2 * kTc * ld;  // [2][kTc][ld]
  bf16* sP = sdO + 2 * kTc * ld;  // [kTc][kPld]: p in bf16, [q][kv]
  bf16* sdS = sP + kTc * kPld;    // [kTc][kPld]: ds in bf16
  float* slse = reinterpret_cast<float*>(sdS + kTc * kPld);  // [2][kTc]
  float* sdelta = slse + 2 * kTc;                            // [2][kTc]
  int* sq = reinterpret_cast<int*>(sdelta + 2 * kTc);        // [2][kTc]
  int* skv = sq + 2 * kTc;                                   // [kTc]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int n_kt = (a.T + kTc - 1) / kTc;
  const int kt = blockIdx.x % n_kt, hk = (blockIdx.x / n_kt) % a.Hkv, b = blockIdx.x / (n_kt * a.Hkv);
  const int gq = a.H / a.Hkv, c0 = kt * kTc;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const bool rot = a.rot.cos != nullptr, vec = a.vec != 0;

  zero_pad_columns<kDkvTcThreads, DMAX>(sK, 6, D);
  tile_load<kDkvTcThreads, DMAX>(sK, ld, kb, a.k_ss, c0, a.T, D, vec, rot, a.rot, b);
  tile_load<kDkvTcThreads, DMAX>(sV, ld, vb, a.v_ss, c0, a.T, D, vec, false, a.rot, b);
  if (a.seg_kv != nullptr && tid < kTc) skv[tid] = c0 + tid < a.T ? a.seg_kv[int64_t(b) * a.T + c0 + tid] : 0;
  cp_commit();
  int lo, hi;
  q_range(a, c0, min(c0 + kTc, a.T) - 1, lo, hi);
  const int rt0 = lo / kTc, n_rt = hi > lo ? (hi - 1) / kTc - rt0 + 1 : 0, items = gq * n_rt;
  // item i: q head hk * gq + i / n_rt, query rows (rt0 + i % n_rt) * kTc ..
  auto issue = [&](int i, int buf) {
    const int h = hk * gq + i / n_rt, r0 = (rt0 + i % n_rt) * kTc;
    const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
    const bf16* dob = static_cast<const bf16*>(a.dout) + b * a.do_sb + h * a.do_sh;
    tile_load<kDkvTcThreads, DMAX>(sQ + buf * kTc * ld, ld, qb, a.q_ss, r0, a.S, D, vec, rot, a.rot, b);
    tile_load<kDkvTcThreads, DMAX>(sdO + buf * kTc * ld, ld, dob, a.do_ss, r0, a.S, D, vec, false, a.rot, b);
    if (tid < kTc) {
      const int r = r0 + tid;
      const int64_t stat = (int64_t(b) * a.H + h) * a.S + r;
      slse[buf * kTc + tid] = r < a.S ? a.lse[stat] : kNegInf;
      sdelta[buf * kTc + tid] = r < a.S ? a.delta[stat] : 0.f;
      if (a.seg_q != nullptr) sq[buf * kTc + tid] = r < a.S ? a.seg_q[int64_t(b) * a.S + r] : 0;
    }
    cp_commit();
  };
  if (items > 0) issue(0, 0);

  float dk[NP][2][4], dv[NP][2][4];
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[i][j][e] = dv[i][j][e] = 0.f;
  // phase 1: warp (wr, wc) = (warp % 4, warp / 4) computes S and dP at query
  // rows 16 wr .., kv columns 32 wc ..; phase 2: warp (kr, dc) = (warp % 4,
  // warp / 4) accumulates kv rows 16 kr .. at the 16-column pairs dc, dc + 2, ..
  const int wr = warp & 3, wc = warp >> 2;
  const uint32_t k_addr = smem_addr(sK + (wc * 32 + bn_row(lane)) * ld + bn_col(lane));
  const uint32_t v_addr = smem_addr(sV + (wc * 32 + bn_row(lane)) * ld + bn_col(lane));
  const uint32_t pt_off = ((bk_col(lane) + (lane & 7)) * kPld + wr * 16 + bn_col(lane)) * 2;
  for (int it = 0; it < items; ++it) {
    const int buf = it & 1, r0 = (rt0 + it % n_rt) * kTc;
    if (it + 1 < items) {
      __syncthreads();  // every warp is done with buffer buf ^ 1 (item it - 1)
      issue(it + 1, buf ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // item it landed; every warp is done with sP and sdS
    const bf16* q_t = sQ + buf * kTc * ld;
    const bf16* do_t = sdO + buf * kTc * ld;
    {
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      const uint32_t q_addr = smem_addr(q_t + (wr * 16 + a_row(lane)) * ld + a_col(lane));
      const uint32_t do_addr = smem_addr(do_t + (wr * 16 + a_row(lane)) * ld + a_col(lane));
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qa[4], da[4];
        ldsm4(qa, q_addr + kk * 32);
        ldsm4(da, do_addr + kk * 32);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t kf[4], vf[4];
          ldsm4(kf, k_addr + (np * 16 * ld + kk * 16) * 2);
          ldsm4(vf, v_addr + (np * 16 * ld + kk * 16) * 2);
          mma_bf16(s[2 * np], qa, kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
          mma_bf16(dp[2 * np], da, vf[0], vf[1]);
          mma_bf16(dp[2 * np + 1], da, vf[2], vf[3]);
        }
      }
      const bool masked = tile_masked(a, r0, c0);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int rl = wr * 16 + g + hr * 8;
        const float lse = slse[buf * kTc + rl], delta = sdelta[buf * kTc + rl];
        const bool live = lse > kNegInf / 2;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float p[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cl = wc * 32 + j * 8 + 2 * t4 + e;
            const bool ok = live && (!masked || valid(a, r0 + rl, c0 + cl, a.seg_q ? sq[buf * kTc + rl] : 0,
                                                      a.seg_kv ? skv[cl] : 0));
            p[e] = ok ? exp2f(__fmul_rn(s[j][2 * hr + e], a.c) - lse) : 0.f;
            ds[e] = __fmul_rn(__fmul_rn(dp[j][2 * hr + e] - delta, p[e]), a.scale);
          }
          const int off = rl * kPld + wc * 32 + j * 8 + 2 * t4;
          *reinterpret_cast<uint32_t*>(sP + off) = pack_bf16(p[0], p[1]);
          *reinterpret_cast<uint32_t*>(sdS + off) = pack_bf16(ds[0], ds[1]);
        }
      }
    }
    __syncthreads();  // p and ds are whole
    {
      const int dc = wc;
      const uint32_t p_addr = smem_addr(sP) + pt_off, ds_addr = smem_addr(sdS) + pt_off;
      const uint32_t do_addr = smem_addr(do_t + bk_row(lane) * ld + bk_col(lane));
      const uint32_t q_addr = smem_addr(q_t + bk_row(lane) * ld + bk_col(lane));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[4], sa[4];
        ldsm4_t(pa, p_addr + kk * 16 * kPld * 2);
        ldsm4_t(sa, ds_addr + kk * 16 * kPld * 2);
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          const int pi = 2 * i + dc;
          uint32_t of[4], qf[4];
          ldsm4_t(of, do_addr + (kk * 16 * ld + pi * 16) * 2);
          ldsm4_t(qf, q_addr + (kk * 16 * ld + pi * 16) * 2);
          mma_bf16(dv[i][0], pa, of[0], of[1]);
          mma_bf16(dv[i][1], pa, of[2], of[3]);
          mma_bf16(dk[i][0], sa, qf[0], qf[1]);
          mma_bf16(dk[i][1], sa, qf[2], qf[3]);
        }
      }
    }
  }
  cp_wait<0>();  // K and V, where no item waited for them
  const int64_t row_stride = int64_t(a.Hkv) * D;
  const int64_t base = (int64_t(b) * a.T * a.Hkv + hk) * D;
  bf16* dk_out = static_cast<bf16*>(a.dk) + base;
  bf16* dv_out = static_cast<bf16*>(a.dv) + base;
  const int kr = warp & 3, dc = warp >> 2;
  float* dk32 = reinterpret_cast<float*>(sQ);  // [kTc][D + 1] fp32 dk for the adjoint
  if (rot) __syncthreads();  // every warp is done with sQ and sdO
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int cl = kr * 16 + g + hr * 8, c = c0 + cl;
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = (2 * i + dc) * 16 + j * 8 + 2 * t4;
        if (d < D) {
          if (c < a.T) {
            *reinterpret_cast<uint32_t*>(dv_out + c * row_stride + d) =
                pack_bf16(dv[i][j][2 * hr], dv[i][j][2 * hr + 1]);
            if (!rot)
              *reinterpret_cast<uint32_t*>(dk_out + c * row_stride + d) =
                  pack_bf16(dk[i][j][2 * hr], dk[i][j][2 * hr + 1]);
          }
          if (rot) {
            dk32[cl * (D + 1) + d] = dk[i][j][2 * hr];
            dk32[cl * (D + 1) + d + 1] = dk[i][j][2 * hr + 1];
          }
        }
      }
  }
  if (rot) {
    __syncthreads();
    store_adjoint<bf16>(dk_out, row_stride, dk32, c0, kTc, a.T, D, a.rot, b);
  }
}

// ---- bf16 on the tensor cores: dq (and delta) ----------------------------------
//
// dq_tc_kernel<DMAX> takes the bf16 inputs of flash_generic_dq. It replaces,
// for them, _bwd_dq_kernel
// (contrastors_tpu/ops/flash_attention.py:422, call :640) with fused_rot
// (_rot_block :76, adjoint _rot_adjoint :87).
//
// What bounds it on an H100: bytes at the main path's shapes (q, dO, O, k
// and v read once, dq written once, against 6*S*T*D FLOP per (batch, head):
// at S = T = 128..257 a few hundred FLOP per byte, under the card's ~295),
// then the exp2 and masking of p in registers. A first design, which
// ran the three products as fp32 FMAs on operands widened in shared memory,
// took about 10x SDPA's whole backward.
//
// What the design does about it (fwd_tc_kernel's loop, with dP beside S):
//   - 4 warps own 64 query rows of one (batch, head), 16 rows each; Q and dO
//     stay bf16 in shared memory, zero-padded to DMAX, and the K / V tiles of
//     kv_range arrive by cp.async (staged through registers where a row is
//     misaligned or rotated);
//   - per kv tile, S = Q K^T and dP = dO V^T on mma.sync.m16n8k16; p and
//     ds = ((dp - delta) * p) * scale in registers, ds rounded to bf16 and fed
//     to dQ += dS K as A fragments straight from the accumulator layout, K the
//     B operand by ldmatrix.trans: dS never goes through shared memory;
//   - registers: dQ is 16 x DMAX fp32 a warp (128 floats a thread at D = 256),
//     so a kv tile is 32 rows (S and dP 16 floats a thread each): at DMAX >
//     128 in one stage, which keeps two blocks a SM, V's next copy under
//     Q K^T and K's under dP of the next tile; at DMAX <= 128 in two stages,
//     the next tile's copies under this tile's products, three blocks a SM
//     (64-row tiles left two, at 224-240 registers, and ran ViT's 64 x 257
//     at D 80 / 88 1.43x as long);
//   - delta = rowsum(dO * O) in fp32 first (16 partial sums over d = lane
//     (mod 16), then group_sum), from O copied into a K / V buffer that the
//     first kv tile does not use; written for dk/dv;
//   - the rotary adjoint runs on the fp32 dq through shared memory, as in
//     dkv_tc_kernel. An empty row's p is 0, so its dq is 0.
// Every dq element has one owner and a fixed order of sums: no atomics,
// bit-identical reruns.

constexpr int kDqTcThreads = 128;  // 4 warps x 16 query rows
constexpr int kDqKv = 32;  // kv rows of a walked tile
template <int DMAX>
constexpr int kDqStages = DMAX > 128 ? 1 : 2;
template <int DMAX>
constexpr int kDqBlocks = DMAX > 128 ? 2 : 3;  // blocks a SM the registers must allow

template <int DMAX>
size_t dq_tc_bytes() {
  constexpr int kv = kDqStages<DMAX> * kDqKv;
  return size_t(2 * kTc + 2 * kv) * (DMAX + 8) * sizeof(bf16) + kTc * sizeof(float) + (kTc + kv) * sizeof(int);
}

template <int DMAX>
__global__ void __launch_bounds__(kDqTcThreads, kDqBlocks<DMAX>) dq_tc_kernel(Args a) {
  constexpr int KS = DMAX / 16, NT = DMAX / 8, BKV = kDqKv, ST = kDqStages<DMAX>, SJ = BKV / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int ld = DMAX + 8;
  const int D = a.D;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [kTc][ld]; after the walk, dq (fp32 for the adjoint)
  bf16* sdO = sQ + kTc * ld;                      // [kTc][ld]
  bf16* sK = sdO + kTc * ld;                      // [ST][K, V][BKV][ld]: stage st's K, then its V
  bf16* sV = sK + BKV * ld;
  float* sdelta = reinterpret_cast<float*>(sK + 2 * ST * BKV * ld);  // [kTc]
  int* sq = reinterpret_cast<int*>(sdelta + kTc);                    // [kTc]
  int* skv = sq + kTc;                                               // [ST][BKV]
  bf16* sO = sK + (ST - 1) * 2 * BKV * ld;  // [kTc][ld]: O for delta, in a stage the first kv tile does not use
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int n_qt = (a.S + kTc - 1) / kTc;
  const int qt = blockIdx.x % n_qt, h = (blockIdx.x / n_qt) % a.H, b = blockIdx.x / (n_qt * a.H);
  const int hk = h / (a.H / a.Hkv), q0 = qt * kTc;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* ob = static_cast<const bf16*>(a.o) + b * a.o_sb + h * a.o_sh;
  const bf16* dob = static_cast<const bf16*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const bool rot = a.rot.cos != nullptr, vec = a.vec != 0;
  const int64_t stat0 = (int64_t(b) * a.H + h) * a.S;
  auto load_k = [&](int c, int st) {
    tile_load<kDqTcThreads, DMAX, BKV>(sK + st * 2 * BKV * ld, ld, kb, a.k_ss, c, a.T, D, vec, rot, a.rot, b);
    if (a.seg_kv != nullptr && tid < BKV)
      skv[st * BKV + tid] = c + tid < a.T ? a.seg_kv[int64_t(b) * a.T + c + tid] : 0;
  };
  auto load_v = [&](int c, int st) {
    tile_load<kDqTcThreads, DMAX, BKV>(sV + st * 2 * BKV * ld, ld, vb, a.v_ss, c, a.T, D, vec, false, a.rot, b);
  };

  zero_pad_columns<kDqTcThreads, DMAX>(sQ, 2 + 2 * ST * BKV / kTc, D);
  tile_load<kDqTcThreads, DMAX>(sQ, ld, qb, a.q_ss, q0, a.S, D, vec, rot, a.rot, b);
  tile_load<kDqTcThreads, DMAX>(sdO, ld, dob, a.do_ss, q0, a.S, D, vec, false, a.rot, b);
  tile_load<kDqTcThreads, DMAX>(sO, ld, ob, a.o_ss, q0, a.S, D, vec, false, a.rot, b);
  if (a.seg_q != nullptr && tid < kTc) sq[tid] = q0 + tid < a.S ? a.seg_q[int64_t(b) * a.S + q0 + tid] : 0;
  cp_commit();
  int lo, hi;
  kv_range(a, q0, min(q0 + kTc, a.S) - 1, lo, hi);
  const int first = lo / BKV * BKV;
  if (ST == 2 && first < hi) {
    load_k(first, 0);
    load_v(first, 0);
  }
  cp_commit();
  cp_wait<1>();
  __syncthreads();  // Q, dO and O landed
  {
    // delta: half-warp `half` of this warp sums rows warp * 16 + 2 i + half
    const int half = lane >> 4, cg = lane & 15;
    for (int i = 0; i < 8; ++i) {
      const int rl = warp * 16 + 2 * i + half, r = q0 + rl;
      float part = 0.f;
      if (r < a.S)
        for (int d = cg; d < D; d += 16)
          part += __bfloat162float(sdO[rl * ld + d]) * __bfloat162float(sO[rl * ld + d]);
      const float delta = group_sum(part);
      if (cg == 0) {
        sdelta[rl] = delta;
        if (r < a.S) a.delta[stat0 + r] = delta;
      }
    }
  }
  __syncthreads();  // every warp is done with O, and sdelta is whole
  if (ST == 1) {    // the first tile's V, then its K, a copy group each
    if (first < hi) load_v(first, 0);
    cp_commit();
    if (first < hi) load_k(first, 0);
    cp_commit();
  }

  const int rl0 = warp * 16 + g;  // this thread's rows rl0 and rl0 + 8 of the tile
  float lse[2], dl[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = q0 + rl0 + hr * 8;
    lse[hr] = r < a.S ? a.lse[stat0 + r] : kNegInf;
    dl[hr] = sdelta[rl0 + hr * 8];
  }
  float dq[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  const uint32_t q_addr = smem_addr(sQ + (warp * 16 + a_row(lane)) * ld + a_col(lane));
  const uint32_t do_addr = smem_addr(sdO + (warp * 16 + a_row(lane)) * ld + a_col(lane));
  const uint32_t k_addr = smem_addr(sK + bn_row(lane) * ld + bn_col(lane));   // K as [n][k], for S
  const uint32_t v_addr = smem_addr(sV + bn_row(lane) * ld + bn_col(lane));   // V as [n][k], for dP
  const uint32_t kt_addr = smem_addr(sK + bk_row(lane) * ld + bk_col(lane));  // K as [k][n], for dQ
  constexpr uint32_t stage_bytes = 2 * BKV * ld * 2;

  // acc (the warp's 16 rows x BKV kv columns) = X Y^T: X's rows at x_addr, the tile Y at y_addr
  auto product = [&](float(&acc)[SJ][4], uint32_t x_addr, uint32_t y_addr) {
#pragma unroll
    for (int j = 0; j < SJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t xa[4];
      ldsm4(xa, x_addr + kk * 32);
#pragma unroll
      for (int np = 0; np < SJ / 2; ++np) {
        uint32_t yf[4];
        ldsm4(yf, y_addr + (np * 16 * ld + kk * 16) * 2);
        mma_bf16(acc[2 * np], xa, yf[0], yf[1]);
        mma_bf16(acc[2 * np + 1], xa, yf[2], yf[3]);
      }
    }
  };
  // s (S of the tile at c0, K in stage st) becomes ds; then dQ += dS K
  auto ds_dq = [&](float(&s)[SJ][4], const float(&dp)[SJ][4], int c0, int st) {
    const bool masked = tile_masked(a, q0, c0, BKV);
    const int* skv_t = skv + st * BKV;
#pragma unroll
    for (int j = 0; j < SJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1, rl = rl0 + hr * 8, cl = j * 8 + 2 * t4 + (e & 1);
        const bool ok = lse[hr] > kNegInf / 2 &&
                        (!masked || valid(a, q0 + rl, c0 + cl, a.seg_q ? sq[rl] : 0, a.seg_kv ? skv_t[cl] : 0));
        const float p = ok ? exp2f(__fmul_rn(s[j][e], a.c) - lse[hr]) : 0.f;
        s[j][e] = __fmul_rn(__fmul_rn(dp[j][e] - dl[hr], p), a.scale);
      }
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kf[4];
        ldsm4_t(kf, kt_addr + st * stage_bytes + (kk * 16 * ld + np * 16) * 2);
        mma_bf16(dq[2 * np], pa, kf[0], kf[1]);
        mma_bf16(dq[2 * np + 1], pa, kf[2], kf[3]);
      }
    }
  };

  if (ST == 2) {
    for (int c0 = first, st = 0; c0 < hi; c0 += BKV, st ^= 1) {
      if (c0 + BKV < hi) {
        __syncthreads();  // every warp is done with stage st ^ 1 (O, before the second tile)
        load_k(c0 + BKV, st ^ 1);
        load_v(c0 + BKV, st ^ 1);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();  // stage st landed
      float s[SJ][4], dp[SJ][4];
      product(dp, do_addr, v_addr + st * stage_bytes);
      product(s, q_addr, k_addr + st * stage_bytes);
      ds_dq(s, dp, c0, st);
    }
  } else {
    for (int c0 = first; c0 < hi; c0 += BKV) {
      const bool next = c0 + BKV < hi;
      cp_wait<1>();
      __syncthreads();  // V landed
      float s[SJ][4], dp[SJ][4];
      product(dp, do_addr, v_addr);
      __syncthreads();  // every warp is done with V
      if (next) load_v(c0 + BKV, 0);
      cp_commit();
      cp_wait<1>();
      __syncthreads();  // K landed
      product(s, q_addr, k_addr);
      ds_dq(s, dp, c0, 0);
      __syncthreads();  // every warp is done with K and skv
      if (next) load_k(c0 + BKV, 0);
      cp_commit();
    }
  }
  cp_wait<0>();
  __syncthreads();  // every warp is done with every tile, and no copy is in flight
  bf16* out = static_cast<bf16*>(a.dq) + (int64_t(b) * a.S * a.H + h) * D;
  const int64_t row_stride = int64_t(a.H) * D;
  if (rot) {
    float* dq32 = reinterpret_cast<float*>(smem_raw);  // [kTc][D + 1]
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int rl = rl0 + hr * 8;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int d = n * 8 + 2 * t4;
        if (d < D) {
          dq32[rl * (D + 1) + d] = dq[n][2 * hr];
          dq32[rl * (D + 1) + d + 1] = dq[n][2 * hr + 1];
        }
      }
    }
    __syncthreads();
    store_adjoint<bf16, kDqTcThreads>(out, row_stride, dq32, q0, kTc, a.S, D, a.rot, b);
    return;
  }
  // dq in bf16 into this warp's own rows of sQ, then 16-byte stores
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int rl = rl0 + hr * 8;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(sQ + rl * ld + n * 8 + 2 * t4) = pack_bf16(dq[n][2 * hr], dq[n][2 * hr + 1]);
  }
  __syncwarp();
  const int chunks = D >> 3;
  for (int idx = lane; idx < 16 * chunks; idx += 32) {
    const int rl = warp * 16 + idx / chunks, c = idx % chunks, r = q0 + rl;
    if (r < a.S)
      *reinterpret_cast<uint4*>(out + r * row_stride + c * 8) = *reinterpret_cast<const uint4*>(sQ + rl * ld + c * 8);
  }
}

// ---- launches ------------------------------------------------------------------

template <int DMAX>
cudaError_t run_tc(int which, const Args& a, cudaStream_t s) {
  if (which == 0)
    return launch(fwd_tc_kernel<DMAX>, fwd_tc_bytes<DMAX>(), (a.S + kTc - 1) / kTc * a.H * a.B, kFwdTcThreads, a, s);
  if (which == 1)
    return launch(dq_tc_kernel<DMAX>, dq_tc_bytes<DMAX>(), (a.S + kTc - 1) / kTc * a.H * a.B, kDqTcThreads, a, s);
  return launch(dkv_tc_kernel<DMAX>, dkv_tc_bytes<DMAX>(), (a.T + kTc - 1) / kTc * a.Hkv * a.B, kDkvTcThreads, a, s);
}

// the tiles are DMAX wide (zero past D), so that their loops unroll at compile time
int dispatch(int which, Args& a, int window, const void* rot_cos, const void* rot_sin, int64_t rot_sb, int rot_half,
             int rot_interleaved, void* stream) {
  bool empty = false;
  const cudaError_t e = prepare(8, which, a, window, rot_cos, rot_sin, rot_sb, rot_half, rot_interleaved, empty, 256);
  if (e != cudaSuccess || empty) return int(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.D <= 64) return int(run_tc<64>(which, a, s));
  if (a.D <= 96) return int(run_tc<96>(which, a, s));
  if (a.D <= 128) return int(run_tc<128>(which, a, s));
  if (a.D <= 192) return int(run_tc<192>(which, a, s));
  return int(run_tc<256>(which, a, s));
}

}  // namespace

// bf16 q/k/v/O/dO/dq/dk/dv (the argument lists: flash_generic_common.cuh)
extern "C" int flash_generic_fwd(FLASH_FWD_PARAMS) {
  FLASH_FWD_ARGS(a);
  return dispatch(0, a, window, rot_cos, rot_sin, rot_sb, rot_half, rot_interleaved, stream);
}

extern "C" int flash_generic_dq(FLASH_DQ_PARAMS) {
  FLASH_DQ_ARGS(a);
  return dispatch(1, a, window, rot_cos, rot_sin, rot_sb, rot_half, rot_interleaved, stream);
}

extern "C" int flash_generic_dkv(FLASH_DKV_PARAMS) {
  FLASH_DKV_ARGS(a);
  return dispatch(2, a, window, rot_cos, rot_sin, rot_sb, rot_half, rot_interleaved, stream);
}
