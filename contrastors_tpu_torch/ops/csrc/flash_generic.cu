// Flash attention forward and backward for every head dim and dtype the
// Pallas kernels take: fp32 or bf16 q/k/v/O, D % 8 == 0 with D <= 256, fp32
// LSE. The Hopper kernels (flash_fwd.cu, flash_bwd.cu) take bf16 at D = 64 or
// 128 only; these kernels take the rest.
//
// Replaces, for those inputs, the Pallas TPU kernels of
// contrastors_tpu/ops/flash_attention.py:
//   flash_generic_fwd - _fwd_kernel_single (:225) and _fwd_kernel (:115),
//   flash_generic_dq  - _bwd_dq_kernel (:422),
//   flash_generic_dkv - _bwd_dkv_kernel (:512),
// with their fused_rot=True forms (_rot_block :76, _rot_adjoint :87) as a
// run-time choice: a NULL cos table means no rotary. The Pallas kernels take
// their scratch and output dtypes from q (:395, :405); so do these, through
// the element type T (float or __nv_bfloat16).
//
// Semantics, those of the plain versions in ops/flash_attention.py:
//   - s = q k^T in fp32, unscaled; c = softmax_scale * log2(e); the row max
//     has a floor of -1e20 / c; masked logits are -1e30, so their p is 0;
//   - forward: p = exp2(s*c - m*c) with an online row max, l = sum p, p cast
//     to T before PV (in fp32 storage), O = acc / l, O = 0 and LSE = -1e30
//     where l == 0, LSE = m*c + log2(l);
//   - backward: delta = rowsum(dO * O) in fp32 (by dq, which writes it for
//     dk/dv); p = exp2(s*c - lse), 0 on rows whose LSE is -1e30;
//     ds = ((dp - delta) * p) * softmax_scale cast to T; dq = ds k,
//     dk = ds^T q, dv = p^T dO with p in fp32 (in bf16 on the bf16 tensor-core
//     dk/dv, within the error model's dv bar); GQA sums dk/dv over the q
//     heads of each kv head (q head h reads kv head h / (H / Hkv));
//   - masks: segments (valid iff seg_q == seg_kv != 0), bottom-right causal
//     (row + causal_offset >= col), window (|row - col| <= window / 2);
//   - rotary: q and k rotated as they are loaded (x * cos + rot(x) * sin,
//     each product and the sum rounded apart, then cast to T), and the
//     adjoint applied to the fp32 dq and dk before their cast.
//
// What bounds the fp32 kernels on an H100: the products, 4*S*T*D FLOP per
// (batch, head) of the forward against 16*S*D bytes (q, k, v, O in fp32,
// S == T): T/4 FLOP per byte. The fp32 forward runs on the tensor cores in
// 3xTF32 (fwd_tf32_kernel below, with its own note): three TF32 products
// per fp32 product keep about fp32's precision at a third of TF32's 495
// TFLOP/s, 2.5x the 67 TFLOP/s of fp32 FMAs. The fp32 dq and dk/dv still
// run fp32 FMAs (the design below). The bf16 forward, dq and dk/dv run on
// the tensor cores too (fwd_tc_kernel, dq_tc_kernel, dkv_tc_kernel below,
// with their own notes).
//
// Design of the fp32 dq and dk/dv, one simple form for the two: a
// block of 256 threads owns a tile of 64 query rows (dq) or of BK
// kv rows (dk/dv) of one (batch, head) and walks the other side's tiles
// through shared memory, every operand widened to fp32 in rows of D + 1
// floats (an odd stride, so that a warp's 16 columns of a product fall in 16
// banks). Each product is C[i][j] += sum_k A(i, k) B(k, j) over shared
// memory (`tile_fma`), thread (rg, cg) = (tid / 16, tid % 16) owning rows
// rg + 16 ii and columns cg + 16 jj: A's reads are broadcasts, B's
// conflict-free. The accumulators of the output tile stay in registers
// across the walk; p (dk/dv) and ds go through shared memory between the
// products of a step. Rows past S or T are zero in shared memory and masked.
// Dead kv tiles under causal or window masking are skipped. The head dim is
// bucketed (64, 128, 256) as a template parameter, which sizes the register
// tiles; D itself is a run-time value. Every output element has one owner
// and a fixed order of sums: no atomics, and two runs on the same inputs are
// bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows of a forward / dq block, and of a dk/dv step
constexpr float kNegInf = -1e30f;

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};
template <>
struct Elem<__nv_bfloat16> {  // bf16 reaches only store_adjoint: the bf16 kernels are the tensor-core ones
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
};

struct Rot {
  const float* cos;  // [L, D] (sb == 0) or [B, L, D]; NULL: no rotary
  const float* sin;
  int64_t sb;
  int half;          // rot_dim / 2
  int interleaved;   // GPT-J pairs (1) or NeoX halves (0)
};

// the rotate-half partner of column d and the sign of rot(x)_d = s * x_partner
__device__ __forceinline__ int partner(int d, const Rot& r) {
  return r.interleaved ? (d ^ 1) : (d < r.half ? d + r.half : d - r.half);
}
__device__ __forceinline__ float rot_sign(int d, const Rot& r) {
  return (r.interleaved ? (d & 1) : (d >= r.half)) ? 1.f : -1.f;
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *out, *dq, *dk, *dv;
  float *lse, *delta;
  const int *seg_q, *seg_kv;
  int B, S, T, H, Hkv, D;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  int causal, causal_offset, w2;  // w2 = window / 2, or -1 without a window
  float c, scale;
  Rot rot;
  int vec;  // every operand's rows are 16-byte aligned: the tensor-core kernels copy them by cp.async
};

__device__ __forceinline__ bool valid(const Args& a, int r, int col, int sq, int skv) {
  return r < a.S && col < a.T && (a.seg_q == nullptr || (sq == skv && skv != 0)) &&
         (!a.causal || r + a.causal_offset >= col) && (a.w2 < 0 || abs(r - col) <= a.w2);
}

// Rows row0 .. row0 + rows - 1 of one (batch, head) of x (base at row 0,
// row stride ss) into dst[r * (D + 1) + d] as fp32, zero past n_valid;
// rotated (and cast back to T, as the plain version rotates) when rot.
template <typename T>
__device__ void load_rows(float* dst, const T* base, int64_t ss, int row0, int rows, int n_valid, int D,
                          const Rot& rot, bool rotate, int b) {
  const int ld = D + 1;
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D, pos = row0 + r;
    float x = 0.f;
    if (pos < n_valid) {
      const T* row = base + pos * ss;
      x = Elem<T>::load(row + d);
      if (rotate && d < 2 * rot.half) {
        const int64_t t = b * rot.sb + int64_t(pos) * D + d;
        const float xp = rot_sign(d, rot) * Elem<T>::load(row + partner(d, rot));
        x = Elem<T>::round(__fadd_rn(__fmul_rn(x, rot.cos[t]), __fmul_rn(xp, rot.sin[t])));
      }
    }
    dst[r * ld + d] = x;
  }
}

// acc[ii][jj] += sum_{k < K} A[(rg + 16 ii) * a_si + k * a_sk] * B[k * b_sk + (cg + 16 jj) * b_sj]
template <int MI, int NJ>
__device__ __forceinline__ void tile_fma(float (&acc)[MI][NJ], const float* A, int a_si, int a_sk, const float* B,
                                         int b_sk, int b_sj, int K, int rg, int cg) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float x[MI], y[NJ];
#pragma unroll
    for (int i = 0; i < MI; ++i) x[i] = A[(rg + 16 * i) * a_si + k * a_sk];
#pragma unroll
    for (int j = 0; j < NJ; ++j) y[j] = B[k * b_sk + (cg + 16 * j) * b_sj];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// a sum over the 16 threads of a row group (lanes 0-15 or 16-31)
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The adjoint of the rotation on an fp32 tile g[r * (D + 1) + d] of rows at
// sequence positions row0 + r, cast to T and stored at out + pos * ss: g * cos
// + rot^T(g * sin), rounded as the plain version rounds (rot^T = -rot).
template <typename T, int NT = kThreads>
__device__ void store_adjoint(T* out, int64_t ss, const float* g, int row0, int rows, int n_valid, int D,
                              const Rot& rot, int b) {
  const int ld = D + 1;
  for (int idx = threadIdx.x; idx < rows * D; idx += NT) {
    const int r = idx / D, d = idx - r * D, pos = row0 + r;
    if (pos >= n_valid) continue;
    float x = g[r * ld + d];
    if (d < 2 * rot.half) {
      const int64_t t = b * rot.sb + int64_t(pos) * D;
      const int p = partner(d, rot);
      const float y = __fmul_rn(g[r * ld + p], rot.sin[t + p]);
      x = __fadd_rn(__fmul_rn(x, rot.cos[t + d]), -rot_sign(d, rot) * y);
    }
    Elem<T>::store(out + pos * ss + d, x);
  }
}

// the kv range [lo, hi) that query rows [r0, r1] can see under causal / window
__device__ __forceinline__ void kv_range(const Args& a, int r0, int r1, int& lo, int& hi) {
  lo = 0;
  hi = a.T;
  if (a.causal) hi = min(hi, r1 + a.causal_offset + 1);
  if (a.w2 >= 0) {
    lo = max(lo, r0 - a.w2);
    hi = min(hi, r1 + a.w2 + 1);
  }
}

// the query range [lo, hi) that kv rows [c0, c1] are seen by
__device__ __forceinline__ void q_range(const Args& a, int c0, int c1, int& lo, int& hi) {
  lo = 0;
  hi = a.S;
  if (a.causal) lo = max(lo, c0 - a.causal_offset);
  if (a.w2 >= 0) {
    lo = max(lo, c0 - a.w2);
    hi = min(hi, c1 + a.w2 + 1);
  }
}

// ---- backward: dq (and delta) ------------------------------------------------

template <int DMAX, int BK>
struct DqSmem {
  static size_t floats(int D) {
    return 2 * (size_t(kBQ) * (D + 1) + DMAX) + 2 * (size_t(BK) * (D + 1) + DMAX) + kBQ * (BK + 1) + kBQ + BK;
  }
};

template <typename T, int DMAX, int BK>
__global__ void __launch_bounds__(kThreads, 1) dq_kernel(Args a) {
  constexpr int MI = kBQ / 16, NJ = DMAX / 16, SJ = BK / 16;
  extern __shared__ float smem[];
  const int D = a.D, ld = D + 1;
  float* Qs = smem;                     // [kBQ][ld]; after the walk, dq in fp32 (rotary)
  float* dOs = Qs + kBQ * ld + DMAX;    // [kBQ][ld]
  float* Ks = dOs + kBQ * ld + DMAX;    // [BK][ld]
  float* Vs = Ks + BK * ld + DMAX;      // [BK][ld]
  float* dSs = Vs + BK * ld + DMAX;     // [kBQ][BK + 1]: ds cast to T
  int* sq = reinterpret_cast<int*>(dSs + kBQ * (BK + 1));
  int* skv = sq + kBQ;
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int n_qt = (a.S + kBQ - 1) / kBQ;
  const int qt = blockIdx.x % n_qt, h = (blockIdx.x / n_qt) % a.H, b = blockIdx.x / (n_qt * a.H);
  const int hk = h / (a.H / a.Hkv), q0 = qt * kBQ;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* ob = static_cast<const T*>(a.o) + b * a.o_sb + h * a.o_sh;
  const T* dob = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const bool rot = a.rot.cos != nullptr;
  const int64_t stat0 = (int64_t(b) * a.H + h) * a.S;

  load_rows<T>(Qs, qb, a.q_ss, q0, kBQ, a.S, D, a.rot, rot, b);
  load_rows<T>(dOs, dob, a.do_ss, q0, kBQ, a.S, D, a.rot, false, b);
  if (a.seg_q != nullptr && tid < kBQ) sq[tid] = q0 + tid < a.S ? a.seg_q[int64_t(b) * a.S + q0 + tid] : 0;
  __syncthreads();
  float lse[MI], delta[MI];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int rl = rg + 16 * i, r = q0 + rl;
    float part = 0.f;
    if (r < a.S)
      for (int d = cg; d < D; d += 16) part += dOs[rl * ld + d] * Elem<T>::load(ob + r * a.o_ss + d);
    delta[i] = group_sum(part);
    lse[i] = r < a.S ? a.lse[stat0 + r] : kNegInf;
    if (r < a.S && cg == 0) a.delta[stat0 + r] = delta[i];
  }
  float dq[MI][NJ];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq[i][j] = 0.f;
  int lo, hi;
  kv_range(a, q0, min(q0 + kBQ, a.S) - 1, lo, hi);
  for (int c0 = lo / BK * BK; c0 < hi; c0 += BK) {
    __syncthreads();
    load_rows<T>(Ks, kb, a.k_ss, c0, BK, a.T, D, a.rot, rot, b);
    load_rows<T>(Vs, vb, a.v_ss, c0, BK, a.T, D, a.rot, false, b);
    if (a.seg_kv != nullptr && tid < BK) skv[tid] = c0 + tid < a.T ? a.seg_kv[int64_t(b) * a.T + c0 + tid] : 0;
    __syncthreads();
    float s[MI][SJ], dp[MI][SJ];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < SJ; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_fma<MI, SJ>(s, Qs, ld, 1, Ks, 1, ld, D, rg, cg);
    tile_fma<MI, SJ>(dp, dOs, ld, 1, Vs, 1, ld, D, rg, cg);
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int rl = rg + 16 * i;
      const bool dead = lse[i] <= kNegInf / 2;
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        const int cl = cg + 16 * j;
        const bool ok = !dead && valid(a, q0 + rl, c0 + cl, a.seg_q ? sq[rl] : 0, a.seg_kv ? skv[cl] : 0);
        const float p = ok ? exp2f(__fmul_rn(s[i][j], a.c) - lse[i]) : 0.f;
        dSs[rl * (BK + 1) + cl] = Elem<T>::round(__fmul_rn(__fmul_rn(dp[i][j] - delta[i], p), a.scale));
      }
    }
    __syncthreads();
    tile_fma<MI, NJ>(dq, dSs, BK + 1, 1, Ks, ld, 1, BK, rg, cg);
  }
  T* out = static_cast<T*>(a.dq);
  const int64_t row_stride = int64_t(a.H) * D;
  T* ob_dq = out + (int64_t(b) * a.S * a.H + h) * D;
  if (rot) {
    __syncthreads();  // Qs is free: dq goes through it for the adjoint
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = cg + 16 * j;
        if (d < D) Qs[(rg + 16 * i) * ld + d] = dq[i][j];
      }
    __syncthreads();
    store_adjoint<T>(ob_dq, row_stride, Qs, q0, kBQ, a.S, D, a.rot, b);
    return;
  }
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int r = q0 + rg + 16 * i;
    if (r >= a.S) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = cg + 16 * j;
      if (d < D) Elem<T>::store(ob_dq + r * row_stride + d, dq[i][j]);
    }
  }
}

// ---- backward: dk and dv -------------------------------------------------------

template <int DMAX, int BK>
struct DkvSmem {
  static size_t floats(int D) {
    return 2 * (size_t(BK) * (D + 1) + DMAX) + 2 * (size_t(kBQ) * (D + 1) + DMAX) + BK * (kBQ + 1) + kBQ + BK;
  }
};

template <typename T, int DMAX, int BK>
__global__ void __launch_bounds__(kThreads, 1) dkv_kernel(Args a) {
  constexpr int MI = BK / 16, NJ = DMAX / 16, SJ = kBQ / 16;
  extern __shared__ float smem[];
  const int D = a.D, ld = D + 1;
  float* Ks = smem;                     // [BK][ld]; after the walk, dk in fp32 (rotary)
  float* Vs = Ks + BK * ld + DMAX;      // [BK][ld]
  float* Qs = Vs + BK * ld + DMAX;      // [kBQ][ld]
  float* dOs = Qs + kBQ * ld + DMAX;    // [kBQ][ld]
  float* Pt = dOs + kBQ * ld + DMAX;    // [BK][kBQ + 1]: p^T, then ds^T cast to T
  int* sq = reinterpret_cast<int*>(Pt + BK * (kBQ + 1));
  int* skv = sq + kBQ;
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int n_kt = (a.T + BK - 1) / BK;
  const int kt = blockIdx.x % n_kt, hk = (blockIdx.x / n_kt) % a.Hkv, b = blockIdx.x / (n_kt * a.Hkv);
  const int gq = a.H / a.Hkv, c0 = kt * BK;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const bool rot = a.rot.cos != nullptr;

  load_rows<T>(Ks, kb, a.k_ss, c0, BK, a.T, D, a.rot, rot, b);
  load_rows<T>(Vs, vb, a.v_ss, c0, BK, a.T, D, a.rot, false, b);
  if (a.seg_kv != nullptr && tid < BK) skv[tid] = c0 + tid < a.T ? a.seg_kv[int64_t(b) * a.T + c0 + tid] : 0;
  float dk[MI][NJ], dv[MI][NJ];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;
  int lo, hi;
  q_range(a, c0, min(c0 + BK, a.T) - 1, lo, hi);
  for (int g = 0; g < gq; ++g) {
    const int h = hk * gq + g;
    const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* dob = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
    const int64_t stat0 = (int64_t(b) * a.H + h) * a.S;
    for (int r0 = lo / kBQ * kBQ; r0 < hi; r0 += kBQ) {
      __syncthreads();
      load_rows<T>(Qs, qb, a.q_ss, r0, kBQ, a.S, D, a.rot, rot, b);
      load_rows<T>(dOs, dob, a.do_ss, r0, kBQ, a.S, D, a.rot, false, b);
      if (a.seg_q != nullptr && tid < kBQ) sq[tid] = r0 + tid < a.S ? a.seg_q[int64_t(b) * a.S + r0 + tid] : 0;
      float lse[SJ], delta[SJ];
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        const int r = r0 + cg + 16 * j;
        lse[j] = r < a.S ? a.lse[stat0 + r] : kNegInf;
        delta[j] = r < a.S ? a.delta[stat0 + r] : 0.f;
      }
      __syncthreads();
      float s[MI][SJ], dp[MI][SJ];  // transposed: rows are kv rows, columns query rows
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < SJ; ++j) s[i][j] = dp[i][j] = 0.f;
      tile_fma<MI, SJ>(s, Ks, ld, 1, Qs, 1, ld, D, rg, cg);
      tile_fma<MI, SJ>(dp, Vs, ld, 1, dOs, 1, ld, D, rg, cg);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int cl = rg + 16 * i;
#pragma unroll
        for (int j = 0; j < SJ; ++j) {
          const int rl = cg + 16 * j;
          const bool ok = lse[j] > kNegInf / 2 &&
                          valid(a, r0 + rl, c0 + cl, a.seg_q ? sq[rl] : 0, a.seg_kv ? skv[cl] : 0);
          s[i][j] = ok ? exp2f(__fmul_rn(s[i][j], a.c) - lse[j]) : 0.f;  // p
          Pt[cl * (kBQ + 1) + rl] = s[i][j];
        }
      }
      __syncthreads();
      tile_fma<MI, NJ>(dv, Pt, kBQ + 1, 1, dOs, ld, 1, kBQ, rg, cg);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < SJ; ++j)
          Pt[(rg + 16 * i) * (kBQ + 1) + cg + 16 * j] =
              Elem<T>::round(__fmul_rn(__fmul_rn(dp[i][j] - delta[j], s[i][j]), a.scale));
      __syncthreads();
      tile_fma<MI, NJ>(dk, Pt, kBQ + 1, 1, Qs, ld, 1, kBQ, rg, cg);
    }
  }
  const int64_t row_stride = int64_t(a.Hkv) * D;
  const int64_t base = (int64_t(b) * a.T * a.Hkv + hk) * D;
  T* dk_out = static_cast<T*>(a.dk) + base;
  T* dv_out = static_cast<T*>(a.dv) + base;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int c = c0 + rg + 16 * i;
    if (c >= a.T) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = cg + 16 * j;
      if (d < D) {
        Elem<T>::store(dv_out + c * row_stride + d, dv[i][j]);
        if (!rot) Elem<T>::store(dk_out + c * row_stride + d, dk[i][j]);
      }
    }
  }
  if (rot) {
    __syncthreads();  // Ks is free: dk goes through it for the adjoint
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = cg + 16 * j;
        if (d < D) Ks[(rg + 16 * i) * ld + d] = dk[i][j];
      }
    __syncthreads();
    store_adjoint<T>(dk_out, row_stride, Ks, c0, BK, a.T, D, a.rot, b);
  }
}

// ---- bf16 on the tensor cores: the forward and dk/dv ---------------------------
//
// The bf16 instantiations of the forward and of dk/dv. They replace, for bf16,
// the Pallas kernels named at the top of this file: the forward
// _fwd_kernel_single (:225) / _fwd_kernel (:115), call :396, with fused_rot
// (_rot_block :76); dk/dv _bwd_dkv_kernel (:512), call :700, adjoint
// :600-604. The fp32 instantiations of dq_kernel and dkv_kernel keep the
// design above; bf16 dq and the fp32 forward have their own kernels and notes
// further down.
//
// What bounds them on an H100: bytes at the main path's shapes (64 x 257 at
// D 80 / 88, pythia-1b's 128-token rows at D 256: a few hundred FLOP per byte
// at most, under the card's ~295), then the softmax's exp2 and masking in
// registers, which a tensor core does not run. The fp32-FMA design above
// reaches neither: its products run at 67 TFLOP/s on operands widened to fp32.
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
//     thread). The rotary adjoint goes through shared memory, as above.
// Dead kv tiles (forward) and q tiles (dk/dv) are skipped; a tile is masked
// element by element only where a mask can cut it. Every output element has
// one owner and a fixed order of sums: no atomics, bit-identical reruns.

typedef __nv_bfloat16 bf16;
constexpr int kTc = 64;             // rows of every bf16 tile
constexpr int kFwdTcThreads = 128;  // 4 warps x 16 query rows
constexpr int kDkvTcThreads = 256;  // 8 warps
constexpr int kPld = kTc + 8;       // row stride of the p / ds tiles (elements)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// lane addresses of the ldmatrix.x4 forms (row, column offsets in a tile):
// the A fragment of a row-major 16 x 16 block; two B fragments (16 rows of
// n) of an [n][k] tile; two B fragments (16 columns of n) of a [k][n] tile
// (.trans); the A fragment of the transpose of a [k][m] tile (.trans)
__device__ __forceinline__ int a_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) << 3; }
__device__ __forceinline__ int bn_row(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int bn_col(int lane) { return ((lane >> 3) & 1) << 3; }
__device__ __forceinline__ int bk_row(int lane) { return (lane & 7) + (((lane >> 3) & 1) << 3); }
__device__ __forceinline__ int bk_col(int lane) { return (lane >> 4) << 3; }

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

// whether rows [r0, r0 + rows) against columns [c0, c0 + cols) need the
// element-wise mask: segments (unless `one_segment`: every key of the tile
// holds the one nonzero id of the block's rows, whose rows with id 0 the
// caller treats as empty), columns past T, or a causal / window edge
// crossing the tile (rows past S are dropped or carry a -1e30 LSE)
__device__ __forceinline__ bool tile_masked(const Args& a, int r0, int c0, int cols = kTc, bool one_segment = false,
                                            int rows = kTc) {
  const int r1 = r0 + rows - 1, c1 = c0 + cols - 1;
  return (a.seg_q != nullptr && !one_segment) || c1 >= a.T || (a.causal && c1 > r0 + a.causal_offset) ||
         (a.w2 >= 0 && (c0 < r1 - a.w2 || c1 > r0 + a.w2));
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
// dq_tc_kernel<DMAX> takes the bf16 inputs of flash_generic_dq (dq_kernel is
// instantiated for fp32 only). It replaces, for them, _bwd_dq_kernel
// (contrastors_tpu/ops/flash_attention.py:422, call :640) with fused_rot
// (_rot_block :76, adjoint _rot_adjoint :87).
//
// What bounds it on an H100: bytes at the main path's shapes (q, dO, O, k
// and v read once, dq written once, against 6*S*T*D FLOP per (batch, head):
// at S = T = 128..257 a few hundred FLOP per byte, under the card's ~295),
// then the exp2 and masking of p in registers. dq_kernel's design, which
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
//   - delta = rowsum(dO * O) in fp32 first, summed in dq_kernel's order (16
//     partial sums over d = lane (mod 16), then group_sum), from O copied into
//     a K / V buffer that the first kv tile does not use; written for dk/dv;
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

// ---- fp32 on the tensor cores: the forward, in 3xTF32 --------------------------
//
// fwd_tf32_kernel<DMAX> takes the fp32 inputs of flash_generic_fwd. It
// replaces, for them, _fwd_kernel_single (contrastors_tpu/ops/flash_attention.py
// :225) and _fwd_kernel (:115), call :396, with fused_rot (_rot_block :76).
//
// What bounds it on an H100: the products (T/4 FLOP per byte, above the
// card's balance at the main path's T = 256 and 512). TF32 on the tensor
// cores runs at 495 TFLOP/s but keeps 10 mantissa bits; fp32 FMAs keep 23
// at 67 TFLOP/s. 3xTF32 keeps about fp32's precision at 495 / 3 ~ 165
// TFLOP/s: each operand x is split into big = rna_tf32(x) and small =
// rna_tf32(x - big) (x - big is exact), and a b is summed as small_a big_b +
// big_a small_b + big_a big_b, in that order, into one fp32 accumulator
// (CUTLASS's OpMultiplyAddFastF32, which PyTorch's fp32 SDPA runs on sm80
// and later). The dropped small_a small_b and the rounding of the small
// parts leave about 2^-21 of each product. The previous design, fp32 FMAs
// over operands in shared memory (dq_kernel's form), took 2.7x SDPA's time.
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
// bit-identical reruns. The fp32 dq and dk/dv keep the fp32-FMA design at
// the top of this file and take this kernel's LSE.

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
// d += a b: a 16 x 8 (row), b 8 x 8 (col), tf32 in, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d[m][i0 + i] += a[m] b[i] for M x G accumulators in 3xTF32 (a = ab + as,
// b = bb + bs): small a big b, then big a small b, then big a big b, each
// pass over all M x G (i < live), so that no product waits on the one before
template <int M, int N, int G>
__device__ __forceinline__ void mma_3xtf32(float (&d)[M][N][4], int i0, const uint32_t (&ab)[M][4],
                                           const uint32_t (&as)[M][4], const uint32_t (&bb)[G][2],
                                           const uint32_t (&bs)[G][2], int live) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int i = 0; i < G; ++i)
      if (i < live) mma_tf32(d[m][i0 + i], as[m], bb[i][0], bb[i][1]);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int i = 0; i < G; ++i)
      if (i < live) mma_tf32(d[m][i0 + i], ab[m], bs[i][0], bs[i][1]);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int i = 0; i < G; ++i)
      if (i < live) mma_tf32(d[m][i0 + i], ab[m], bb[i][0], bb[i][1]);
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

// ---- launches ------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, int blocks, int threads, const Args& a, cudaStream_t s) {
  const int bytes = int(smem);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  if (blocks == 0) return cudaSuccess;
  kernel<<<blocks, threads, bytes, s>>>(a);
  return cudaGetLastError();
}

// kv tile rows by head-dim bucket: 32 at D > 128, where 64 would not leave
// the dq and dk/dv kernels' tiles in shared memory
template <int DMAX>
constexpr int kKvTile = DMAX > 128 ? 32 : 64;

template <typename T, int DMAX>
cudaError_t run(int which, const Args& a, cudaStream_t s) {  // fp32 dq (1) and dk/dv (2)
  constexpr int BK = kKvTile<DMAX>;
  const int n_qt = (a.S + kBQ - 1) / kBQ, n_kt = (a.T + BK - 1) / BK;
  constexpr size_t F = sizeof(float);
  if (which == 1)
    return launch(dq_kernel<T, DMAX, BK>, DqSmem<DMAX, BK>::floats(a.D) * F, n_qt * a.H * a.B, kThreads, a, s);
  return launch(dkv_kernel<T, DMAX, BK>, DkvSmem<DMAX, BK>::floats(a.D) * F, n_kt * a.Hkv * a.B, kThreads, a, s);
}

// fp32 forward: the 3xTF32 tensor-core kernel
template <int DMAX>
cudaError_t run_fwd_tf32(const Args& a, cudaStream_t s) {
  constexpr int BQ = 64 * kTf32M<DMAX>;
  return launch(fwd_tf32_kernel<DMAX>, fwd_tf32_bytes(a.D, BQ, kTf32Kv<DMAX>), (a.S + BQ - 1) / BQ * a.H * a.B,
                kFwdF32Threads, a, s);
}

// bf16: the three kernels on the tensor cores
template <int DMAX>
cudaError_t run_tc(int which, const Args& a, cudaStream_t s) {
  if (which == 0)
    return launch(fwd_tc_kernel<DMAX>, fwd_tc_bytes<DMAX>(), (a.S + kTc - 1) / kTc * a.H * a.B, kFwdTcThreads, a, s);
  if (which == 1)
    return launch(dq_tc_kernel<DMAX>, dq_tc_bytes<DMAX>(), (a.S + kTc - 1) / kTc * a.H * a.B, kDqTcThreads, a, s);
  return launch(dkv_tc_kernel<DMAX>, dkv_tc_bytes<DMAX>(), (a.T + kTc - 1) / kTc * a.Hkv * a.B, kDkvTcThreads, a, s);
}

template <typename T>
cudaError_t run_dtype(int which, const Args& a, cudaStream_t s) {  // fp32
  if (which == 0) {
    if (a.D <= 64) return run_fwd_tf32<64>(a, s);
    if (a.D <= 128) return run_fwd_tf32<128>(a, s);
    return run_fwd_tf32<256>(a, s);
  }
  if (a.D <= 64) return run<T, 64>(which, a, s);
  if (a.D <= 128) return run<T, 128>(which, a, s);
  return run<T, 256>(which, a, s);
}
// bf16: the tensor-core kernels' tiles are DMAX wide (zero past D), so that
// their loops unroll at compile time
template <>
cudaError_t run_dtype<bf16>(int which, const Args& a, cudaStream_t s) {
  if (a.D <= 64) return run_tc<64>(which, a, s);
  if (a.D <= 96) return run_tc<96>(which, a, s);
  if (a.D <= 128) return run_tc<128>(which, a, s);
  if (a.D <= 192) return run_tc<192>(which, a, s);
  return run_tc<256>(which, a, s);
}

// a base pointer and (batch, sequence, head) strides that keep every row
// 16-byte aligned; `per16` elements make 16 bytes
bool rows_aligned(const void* p, int64_t sb, int64_t ss, int64_t sh, int per16) {
  return p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % per16 == 0 && ss % per16 == 0 &&
         sh % per16 == 0;
}

int dispatch(int dtype, int which, Args& a, int window, const void* rot_cos, const void* rot_sin, int64_t rot_sb,
             int rot_half, int rot_interleaved, void* stream) {
  if ((dtype != 0 && dtype != 1) || a.Hkv <= 0 || a.H % a.Hkv != 0 || a.D % 8 != 0 || a.D < 8 || a.D > 256 ||
      (rot_cos != nullptr && (rot_half <= 0 || 2 * rot_half > a.D)))
    return int(cudaErrorInvalidValue);
  if (a.B == 0 || a.S == 0 || a.H == 0) return int(cudaSuccess);
  a.w2 = window > 0 ? window / 2 : -1;
  const int per16 = dtype == 0 ? 4 : 8;
  a.vec = rows_aligned(a.q, a.q_sb, a.q_ss, a.q_sh, per16) && rows_aligned(a.k, a.k_sb, a.k_ss, a.k_sh, per16) &&
          rows_aligned(a.v, a.v_sb, a.v_ss, a.v_sh, per16) &&
          (which == 0 || rows_aligned(a.dout, a.do_sb, a.do_ss, a.do_sh, per16)) &&
          (which != 1 || rows_aligned(a.o, a.o_sb, a.o_ss, a.o_sh, per16));
  a.rot = Rot{static_cast<const float*>(rot_cos), static_cast<const float*>(rot_sin), rot_sb, rot_half,
              rot_interleaved};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(dtype == 0 ? run_dtype<float>(which, a, s) : run_dtype<__nv_bfloat16>(which, a, s));
}

}  // namespace

// dtype: 0 fp32, 1 bf16. Outputs are contiguous [B, S, H, D] (O, dq),
// [B, T, Hkv, D] (dk, dv) and [B, H, S] fp32 (LSE, delta); inputs take any
// batch, sequence and head strides with a unit stride over D.
extern "C" int flash_generic_fwd(int dtype, const void* q, const void* k, const void* v, void* o, void* lse,
                                 const void* seg_q, const void* seg_kv, int B, int S, int T, int H, int Hkv, int D,
                                 int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                                 int64_t v_sb, int64_t v_ss, int64_t v_sh, int causal, int causal_offset, int window,
                                 float c, const void* rot_cos, const void* rot_sin, int64_t rot_sb, int rot_half,
                                 int rot_interleaved, void* stream) {
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.out = o; a.lse = static_cast<float*>(lse);
  a.seg_q = static_cast<const int*>(seg_q); a.seg_kv = static_cast<const int*>(seg_kv);
  a.B = B; a.S = S; a.T = T; a.H = H; a.Hkv = Hkv; a.D = D;
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh; a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;
  a.causal = causal; a.causal_offset = causal_offset; a.c = c;
  return dispatch(dtype, 0, a, window, rot_cos, rot_sin, rot_sb, rot_half, rot_interleaved, stream);
}

extern "C" int flash_generic_dq(int dtype, const void* q, const void* k, const void* v, const void* dout,
                                const void* o, const void* lse, void* delta, void* dq, const void* seg_q,
                                const void* seg_kv, int B, int S, int T, int H, int Hkv, int D, int64_t q_sb,
                                int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                                int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh, int64_t do_sb,
                                int64_t do_ss, int64_t do_sh, int causal, int causal_offset, int window, float c,
                                float scale, const void* rot_cos, const void* rot_sin, int64_t rot_sb, int rot_half,
                                int rot_interleaved, void* stream) {
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.o = o;
  a.lse = const_cast<float*>(static_cast<const float*>(lse)); a.delta = static_cast<float*>(delta); a.dq = dq;
  a.seg_q = static_cast<const int*>(seg_q); a.seg_kv = static_cast<const int*>(seg_kv);
  a.B = B; a.S = S; a.T = T; a.H = H; a.Hkv = Hkv; a.D = D;
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh; a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh; a.o_sb = o_sb; a.o_ss = o_ss; a.o_sh = o_sh;
  a.do_sb = do_sb; a.do_ss = do_ss; a.do_sh = do_sh;
  a.causal = causal; a.causal_offset = causal_offset; a.c = c; a.scale = scale;
  return dispatch(dtype, 1, a, window, rot_cos, rot_sin, rot_sb, rot_half, rot_interleaved, stream);
}

extern "C" int flash_generic_dkv(int dtype, const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv, const void* seg_q,
                                 const void* seg_kv, int B, int S, int T, int H, int Hkv, int D, int64_t q_sb,
                                 int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                                 int64_t v_ss, int64_t v_sh, int64_t do_sb, int64_t do_ss, int64_t do_sh, int causal,
                                 int causal_offset, int window, float c, float scale, const void* rot_cos,
                                 const void* rot_sin, int64_t rot_sb, int rot_half, int rot_interleaved, void* stream) {
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.delta = const_cast<float*>(static_cast<const float*>(delta)); a.dk = dk; a.dv = dv;
  a.seg_q = static_cast<const int*>(seg_q); a.seg_kv = static_cast<const int*>(seg_kv);
  a.B = B; a.S = S; a.T = T; a.H = H; a.Hkv = Hkv; a.D = D;
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh; a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh; a.do_sb = do_sb; a.do_ss = do_ss; a.do_sh = do_sh;
  a.causal = causal; a.causal_offset = causal_offset; a.c = c; a.scale = scale;
  return dispatch(dtype, 2, a, window, rot_cos, rot_sin, rot_sb, rot_half, rot_interleaved, stream);
}
