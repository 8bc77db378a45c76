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
//     dk = ds^T q, dv = p^T dO with p in fp32; GQA sums dk/dv over the q
//     heads of each kv head (q head h reads kv head h / (H / Hkv));
//   - masks: segments (valid iff seg_q == seg_kv != 0), bottom-right causal
//     (row + causal_offset >= col), window (|row - col| <= window / 2);
//   - rotary: q and k rotated as they are loaded (x * cos + rot(x) * sin,
//     each product and the sum rounded apart, then cast to T), and the
//     adjoint applied to the fp32 dq and dk before their cast.
//
// What bounds it on an H100: the products. In fp32 there is no tensor-core
// rate that keeps the plain version's precision (single-pass TF32 keeps ~10
// bits), so the products are fp32 FMAs: 67 TFLOP/s at most, against 4*S*T*D
// FLOP per (batch, head) on 8*S*D bytes (fp32, S == T), i.e. T/4 FLOP per
// byte: operations bound above T ~ 80. bf16 runs the same FMAs on operands
// widened on load (their products are exact in fp32), so it is far from the
// tensor cores' 989 TFLOP/s: these kernels are for coverage, and the Hopper
// kernels keep the shapes the main path runs.
//
// Design, one simple form for the three kernels: a block of 256 threads owns
// a tile of 64 query rows (forward, dq) or of BK kv rows (dk/dv) of one
// (batch, head) and walks the other side's tiles through shared memory,
// every operand widened to fp32 in rows of D + 1 floats (an odd stride, so
// that a warp's 16 columns of a product fall in 16 banks). Each product is
// C[i][j] += sum_k A(i, k) B(k, j) over shared memory (`tile_fma`), thread
// (rg, cg) = (tid / 16, tid % 16) owning rows rg + 16 ii and columns
// cg + 16 jj: A's reads are broadcasts, B's conflict-free. The accumulators
// of the output tile stay in registers across the walk; p and ds go through
// shared memory between the two products of a step. Rows past S or T are
// zero in shared memory and masked. Dead kv tiles under causal or window
// masking are skipped. The head dim is bucketed (64, 128, 256) as a template
// parameter, which sizes the register tiles; D itself is a run-time value.
// Every output element has one owner and a fixed order of sums: no atomics,
// and two runs on the same inputs are bit-identical.

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
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
  static __device__ __forceinline__ float round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
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

// reductions over the 16 threads of a row group (lanes 0-15 or 16-31)
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The adjoint of the rotation on an fp32 tile g[r * (D + 1) + d] of rows at
// sequence positions row0 + r, cast to T and stored at out + pos * ss: g * cos
// + rot^T(g * sin), rounded as the plain version rounds (rot^T = -rot).
template <typename T>
__device__ void store_adjoint(T* out, int64_t ss, const float* g, int row0, int rows, int n_valid, int D,
                              const Rot& rot, int b) {
  const int ld = D + 1;
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
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

template <int DMAX, int BK>
struct FwdSmem {
  static size_t floats(int D) { return size_t(kBQ) * (D + 1) + DMAX + size_t(BK) * (D + 1) + DMAX + kBQ * (BK + 1) + kBQ + BK; }
};

// ---- forward ---------------------------------------------------------------

template <typename T, int DMAX, int BK>
__global__ void __launch_bounds__(kThreads, 1) fwd_kernel(Args a) {
  constexpr int MI = kBQ / 16, NJ = DMAX / 16, SJ = BK / 16;
  extern __shared__ float smem[];
  const int D = a.D, ld = D + 1;
  float* Qs = smem;                         // [kBQ][ld] (+ DMAX of slack for reads past D)
  float* KVs = Qs + kBQ * ld + DMAX;        // [BK][ld]: k, then v, of the walked tile
  float* Ps = KVs + BK * ld + DMAX;         // [kBQ][BK + 1]: p cast to T
  int* sq = reinterpret_cast<int*>(Ps + kBQ * (BK + 1));  // [kBQ]
  int* skv = sq + kBQ;                                     // [BK]
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int n_qt = (a.S + kBQ - 1) / kBQ;
  const int qt = blockIdx.x % n_qt, h = (blockIdx.x / n_qt) % a.H, b = blockIdx.x / (n_qt * a.H);
  const int hk = h / (a.H / a.Hkv), q0 = qt * kBQ;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const bool rot = a.rot.cos != nullptr;

  load_rows<T>(Qs, qb, a.q_ss, q0, kBQ, a.S, D, a.rot, rot, b);
  if (a.seg_q != nullptr && tid < kBQ) sq[tid] = q0 + tid < a.S ? a.seg_q[int64_t(b) * a.S + q0 + tid] : 0;

  float o[MI][NJ], m[MI], l[MI];
  const float floor_m = -1e20f / a.c;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    m[i] = floor_m;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[i][j] = 0.f;
  }
  int lo, hi;
  kv_range(a, q0, min(q0 + kBQ, a.S) - 1, lo, hi);
  for (int c0 = lo / BK * BK; c0 < hi; c0 += BK) {
    __syncthreads();  // the previous step is done with KVs, Ps and skv
    load_rows<T>(KVs, kb, a.k_ss, c0, BK, a.T, D, a.rot, rot, b);
    if (a.seg_kv != nullptr && tid < BK) skv[tid] = c0 + tid < a.T ? a.seg_kv[int64_t(b) * a.T + c0 + tid] : 0;
    __syncthreads();
    float s[MI][SJ];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < SJ; ++j) s[i][j] = 0.f;
    tile_fma<MI, SJ>(s, Qs, ld, 1, KVs, 1, ld, D, rg, cg);
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int rl = rg + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        const int cl = cg + 16 * j;
        if (!valid(a, q0 + rl, c0 + cl, a.seg_q ? sq[rl] : 0, a.seg_kv ? skv[cl] : 0)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float mc = __fmul_rn(m_new, a.c), alpha = exp2f(__fmul_rn(m[i], a.c) - mc);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        const float p = exp2f(__fmul_rn(s[i][j], a.c) - mc);
        sum += p;
        Ps[rl * (BK + 1) + cg + 16 * j] = Elem<T>::round(p);
      }
      l[i] = l[i] * alpha + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) o[i][j] *= alpha;
    }
    __syncthreads();  // every thread is done with k
    load_rows<T>(KVs, vb, a.v_ss, c0, BK, a.T, D, a.rot, false, b);
    __syncthreads();
    tile_fma<MI, NJ>(o, Ps, BK + 1, 1, KVs, ld, 1, BK, rg, cg);
  }
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int r = q0 + rg + 16 * i;
    if (r >= a.S) continue;
    const bool dead = l[i] == 0.f;
    T* row = out + ((int64_t(b) * a.S + r) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = cg + 16 * j;
      if (d < D) Elem<T>::store(row + d, dead ? 0.f : o[i][j] / l[i]);
    }
    if (cg == 0) a.lse[(int64_t(b) * a.H + h) * a.S + r] = dead ? kNegInf : __fmul_rn(m[i], a.c) + log2f(l[i]);
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

// ---- launches ------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t floats, int blocks, const Args& a, cudaStream_t s) {
  const int bytes = int(floats * sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  if (blocks == 0) return cudaSuccess;
  kernel<<<blocks, kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

// kv tile rows by head-dim bucket: 32 at D > 128, where 64 would not leave
// the dq and dk/dv kernels' tiles in shared memory
template <typename T, int DMAX>
cudaError_t run(int which, const Args& a, cudaStream_t s) {
  constexpr int BK = DMAX > 128 ? 32 : 64;
  const int n_qt = (a.S + kBQ - 1) / kBQ, n_kt = (a.T + BK - 1) / BK;
  if (which == 0) return launch(fwd_kernel<T, DMAX, BK>, FwdSmem<DMAX, BK>::floats(a.D), n_qt * a.H * a.B, a, s);
  if (which == 1) return launch(dq_kernel<T, DMAX, BK>, DqSmem<DMAX, BK>::floats(a.D), n_qt * a.H * a.B, a, s);
  return launch(dkv_kernel<T, DMAX, BK>, DkvSmem<DMAX, BK>::floats(a.D), n_kt * a.Hkv * a.B, a, s);
}

template <typename T>
cudaError_t run_dtype(int which, const Args& a, cudaStream_t s) {
  if (a.D <= 64) return run<T, 64>(which, a, s);
  if (a.D <= 128) return run<T, 128>(which, a, s);
  return run<T, 256>(which, a, s);
}

int dispatch(int dtype, int which, Args& a, int window, const void* rot_cos, const void* rot_sin, int64_t rot_sb,
             int rot_half, int rot_interleaved, void* stream) {
  if ((dtype != 0 && dtype != 1) || a.Hkv <= 0 || a.H % a.Hkv != 0 || a.D % 8 != 0 || a.D < 8 || a.D > 256 ||
      (rot_cos != nullptr && (rot_half <= 0 || 2 * rot_half > a.D)))
    return int(cudaErrorInvalidValue);
  if (a.B == 0 || a.S == 0 || a.H == 0) return int(cudaSuccess);
  a.w2 = window > 0 ? window / 2 : -1;
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
