// Flash attention forward and backward at head dims above 256 (D % 8 == 0,
// no upper bound), in bf16 and fp32, fp32 LSE: the head dims that
// flash_generic.cu (bf16) and flash_tf32.cu (fp32) do not take. What the
// files share (arguments, masks, rotary, ranges, copies, the tensor-core
// helpers, and the semantics) is in flash_generic_common.cuh.
//
// Replaces, for those inputs, the Pallas TPU kernels of
// contrastors_tpu/ops/flash_attention.py:
//   flash_wide_fwd_{bf16,f32} - _fwd_kernel_single (:225) and _fwd_kernel (:115), call :396,
//   flash_wide_dq_{bf16,f32}  - _bwd_dq_kernel (:422), call :640,
//   flash_wide_dkv_{bf16,f32} - _bwd_dkv_kernel (:512), call :700,
// with their fused_rot=True forms (_rot_block :76, _rot_adjoint :87) as a
// run-time choice: a NULL cos table means no rotary. The Pallas kernels take
// the whole head dim as the last dim of every block; here it does not fit.
//
// What bounds them on an H100: bytes at the main path's shapes (pythia-1b's
// width read as 4 heads of 512: 128-token rows, a few hundred FLOP per byte
// of attention's own operands), so a design that recomputes products to keep
// shared memory and registers within a block's share costs little there.
// The DMAX-256 kernels keep each output row (O, dq, dk, dv) in registers and
// their operand tiles whole in shared memory; at D > 256 neither fits.
//
// What the design does about it:
//   - a grid axis over column slices of the output: a block owns 64 fixed
//     rows (fwd / dq: query rows; dk/dv: kv rows) and the columns dv0 ..
//     dv0 + cols of their output, at most kWideSlice (256 for O and dq, 128
//     for dk and dv, which a warp holds both of); the slices of a head dim
//     are of equal width, a multiple of 8 (D 320: 2 x 160);
//   - the products whose contraction runs over the whole head dim (S = Q K^T;
//     dP = dO V^T; dk/dv: S^T = K Q^T, dP^T = V dO^T) stream both operands
//     through shared memory in chunks of 64 columns in bf16, 32 in fp32 (the
//     last one partial, zero-filled past D), two stages: the next chunk's
//     copies run under this one's products. Shared memory does not depend on
//     D: 44-73 KB a block in bf16, 61-89 KB in fp32, so that two blocks share
//     an SM (the registers, 234-255 a thread, allow no more). With 64-column
//     fp32 chunks and a second slice buffer (119-172 KB, one block an SM) the
//     fp32 kernels took 1.5-1.6x as long at pythia-1b's step documents read
//     as 4 heads of 512 (tools/generic_kernel_probe.py, in turns);
//   - every slice block of the same rows computes the same S (and dP) in the
//     same order of sums, so m, l, the LSE and delta agree bit for bit across
//     slices; slice 0 writes the LSE (forward) and delta (dq). Each dq block
//     sums delta = rowsum(dO * O) over the whole D itself, before its walk;
//   - each block loads only its slice of the operand of the second product
//     (forward: V; dq: K; dk/dv: dO and Q) into one buffer, issued with the
//     walked tile's second chunk, when every warp is done with the previous
//     tile's (D > 256 makes two chunks at least);
//   - 4 warps own 16 fixed rows each and walk tiles of 32 rows of the other
//     side (fwd / dq: kv rows over kv_range; dk/dv: query rows over q_range,
//     for every q head of the GQA group); the C W products (P V, dS K, P^T dO,
//     dS^T Q) take p or ds straight from the accumulator registers;
//   - bf16: mma.sync.m16n8k16 (ldmatrix operands, tiles in rows of width + 8
//     elements: an odd multiple of 16 bytes); fp32: 3xTF32 on
//     mma.sync.m16n8k8 (flash_tf32.cu's note), tiles in rows of width + 4
//     floats;
//   - rows arrive by 16-byte cp.async where every operand's rows are 16-byte
//     aligned (Args.vec), else staged through registers, as are rotated q / k
//     chunks, whose partner column is read from device memory (it may lie in
//     another chunk);
//   - the rotary adjoint on dq and dk needs g at the partner column, which
//     for NeoX halves may lie in another slice block: with rotary the dq and
//     dk/dv kernels store the fp32 gradient before its adjoint into a buffer
//     of the caller's, and wide_adjoint_kernel (not a TPU kernel: the pass
//     _rot_adjoint runs inside the Pallas kernels) applies store_adjoint's
//     arithmetic and the cast.
// Every output element has one owner and a fixed order of sums: no atomics,
// bit-identical reruns.

#include "flash_generic_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;
constexpr int kWideThreads = 128;  // 4 warps
constexpr int kWideRows = 64;      // fixed rows of a block, 16 a warp
constexpr int kWideWalk = 32;      // rows of a walked tile
template <int WHICH>
constexpr int kWideSlice = WHICH == 2 ? 128 : 256;  // the widest output slice of a block (which: 0 fwd, 1 dq, 2 dk/dv)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void cast_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void cast_store(bf16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(x, y);
}

// The two products of the wide kernels on the tensor cores, per element type.
// Accumulators c[j][e] of a warp hold its row g + 8 (e >> 1), walked column
// 8 j + 2 t + (e & 1) (g = lane / 4, t = lane % 4), for both types.
template <typename T>
struct WideMma;

template <>
struct WideMma<bf16> {
  static constexpr int kChunk = 64;  // columns of a chunk of the products over D
  static constexpr int kPad = 8;     // row stride = width + 8 elements
  // acc += X W^T over the chunk's first kcols columns (past them, zero up to
  // a multiple of 16): X the warp's 16 rows at x, W the walked tile at w
  template <int SJ>
  static __device__ __forceinline__ void product_nt(float (&acc)[SJ][4], const bf16* x, const bf16* w, int ld,
                                                    int kcols) {
    const int lane = threadIdx.x & 31;
    const uint32_t xa = smem_addr(x + a_row(lane) * ld + a_col(lane));
    const uint32_t wa = smem_addr(w + bn_row(lane) * ld + bn_col(lane));
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      if (kk * 16 >= kcols) break;
      uint32_t xf[4];
      ldsm4(xf, xa + kk * 32);
#pragma unroll
      for (int np = 0; np < SJ / 2; ++np) {
        uint32_t wf[4];
        ldsm4(wf, wa + (np * 16 * ld + kk * 16) * 2);
        mma_bf16(acc[2 * np], xf, wf[0], wf[1]);
        mma_bf16(acc[2 * np + 1], xf, wf[2], wf[3]);
      }
    }
  }
  // out += C W: C the accumulators c (16 rows x 8 SJ walked rows) rounded to
  // bf16 as A fragments, W the walked tile's slice at w over `cols` columns
  template <int SJ, int NC>
  static __device__ __forceinline__ void product_cw(float (&out)[NC][4], const float (&c)[SJ][4], const bf16* w,
                                                    int ld, int cols) {
    const int lane = threadIdx.x & 31;
    const uint32_t wa = smem_addr(w + bk_row(lane) * ld + bk_col(lane));
#pragma unroll
    for (int kk = 0; kk < SJ / 2; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
      pa[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
      pa[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
      pa[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
#pragma unroll
      for (int np = 0; np < NC / 2; ++np) {
        if (np * 16 >= cols) break;
        uint32_t wf[4];
        ldsm4_t(wf, wa + (kk * 16 * ld + np * 16) * 2);
        mma_bf16(out[2 * np], pa, wf[0], wf[1]);
        mma_bf16(out[2 * np + 1], pa, wf[2], wf[3]);
      }
    }
  }
};

template <>
struct WideMma<float> {
  static constexpr int kChunk = 32;  // half bf16's: two blocks an SM fit in shared memory
  static constexpr int kPad = 4;     // row stride = width + 4 floats: = 4 (mod 8), fragment reads in 32 banks
  template <int SJ>
  static __device__ __forceinline__ void product_nt(float (&acc)[SJ][4], const float* x, const float* w, int ld,
                                                    int kcols) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
    const float* xf = x + g * ld + t4;
    const float* wf = w + g * ld + t4;
    auto& acc1 = reinterpret_cast<float(&)[1][SJ][4]>(acc);
#pragma unroll
    for (int kk = 0; kk < kChunk / 8; ++kk) {
      if (kk * 8 >= kcols) break;
      uint32_t ab[1][4], as[1][4];
      a_frag(xf + kk * 8, ld, ab[0], as[0]);
#pragma unroll
      for (int j0 = 0; j0 < SJ; j0 += 4) {
        uint32_t bb[4][2], bs[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* wr = wf + (j0 + i) * 8 * ld + kk * 8;
          split_tf32_fast(wr[0], bb[i][0], bs[i][0]);
          split_tf32_fast(wr[4], bb[i][1], bs[i][1]);
        }
        mma_3xtf32<1, SJ, 4>(acc1, j0, ab, as, bb, bs, 4);
      }
    }
  }
  template <int SJ, int NC>
  static __device__ __forceinline__ void product_cw(float (&out)[NC][4], const float (&c)[SJ][4], const float* w,
                                                    int ld, int cols) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
    ::product_cw<1, SJ, NC>(reinterpret_cast<float(&)[1][NC][4]>(out), reinterpret_cast<const float(&)[1][SJ][4]>(c),
                            w + 2 * t4 * ld + g, ld, cols);
  }
};

// ROWS rows row0 .. of one (batch, head) of x (row stride ss), columns col0 ..
// col0 + width (width <= COLS), into dst (row stride ld); zero in rows past
// n_valid and in columns past D. By 16-byte cp.async when `async`, else
// staged through registers, rotated (q, k) as the plain version rotates when
// `rotate`: the partner column is read from device memory.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void wide_load(T* dst, int ld, const T* base, int64_t ss, int row0, int n_valid, int col0,
                                          int width, int D, bool async, bool rotate, const Rot& rot, int b) {
  if (async && !rotate) {
    constexpr int EPS = 16 / sizeof(T), SLOTS = COLS / EPS;  // elements of a 16-byte slot; slots of a row
    for (int idx = threadIdx.x; idx < ROWS * SLOTS; idx += kWideThreads) {
      const int r = idx / SLOTS, c = (idx - r * SLOTS) * EPS, pos = row0 + r, d = col0 + c;
      if (c >= width) continue;
      const bool ok = pos < n_valid && d < D;
      cp_async16(smem_addr(dst + r * ld + c), ok ? base + int64_t(pos) * ss + d : base, ok);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < ROWS * COLS; idx += kWideThreads) {
    const int r = idx / COLS, c = idx - r * COLS, pos = row0 + r, d = col0 + c;
    if (c >= width) continue;
    float x = 0.f;
    if (pos < n_valid && d < D) {
      const T* row = base + int64_t(pos) * ss;
      x = to_f32(row[d]);
      if (rotate && d < 2 * rot.half) {
        const int64_t t = b * rot.sb + int64_t(pos) * D + d;
        const float xp = rot_sign(d, rot) * to_f32(row[partner(d, rot)]);
        x = __fadd_rn(__fmul_rn(x, rot.cos[t]), __fmul_rn(xp, rot.sin[t]));
      }
    }
    cast_store(dst + r * ld + c, x);
  }
}

template <int WHICH>
constexpr int kWideProducts = WHICH == 0 ? 1 : 2;  // products over D a walked tile: S (and dP)
template <int WHICH>
constexpr int kWideOutputs = WHICH == 2 ? 2 : 1;  // outputs a block accumulates: O; dq; dv and dk

template <typename T, int WHICH>
size_t wide_bytes() {
  using M = WideMma<T>;
  constexpr int NP = kWideProducts<WHICH>, NO = kWideOutputs<WHICH>;
  return (size_t(2 * NP) * (kWideRows + kWideWalk) * (M::kChunk + M::kPad) +
          size_t(NO) * kWideWalk * (kWideSlice<WHICH> + M::kPad)) * sizeof(T);
}

// The forward (WHICH 0), dq (1) and dk/dv (2) for D > 256 in T (bf16 or fp32).
template <typename T, int WHICH>
__global__ void __launch_bounds__(kWideThreads) wide_kernel(Args a) {
  using M = WideMma<T>;
  constexpr int W = kWideSlice<WHICH>, NC = W / 8, SJ = kWideWalk / 8;
  constexpr int NP = kWideProducts<WHICH>, NO = kWideOutputs<WHICH>;
  constexpr int FX = kWideRows, WK = kWideWalk, KC = M::kChunk;
  constexpr int ldc = KC + M::kPad, lds = W + M::kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sX = reinterpret_cast<T*>(smem_raw);  // [2 stages][NP][FX][ldc]: chunks of the fixed rows' operands
  T* sW = sX + 2 * NP * FX * ldc;          // [2 stages][NP][WK][ldc]: chunks of the walked rows' operands
  T* sS = sW + 2 * NP * WK * ldc;          // [NO][WK][lds]: the walked tile's slices
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
  const int D = a.D, NK = (D + KC - 1) / KC;
  const int n_slices = (D + W - 1) / W, slice_w = ((D + n_slices - 1) / n_slices + 7) / 8 * 8;
  const int slice = blockIdx.x % n_slices, rest = blockIdx.x / n_slices;
  const int dv0 = slice * slice_w, cols = min(slice_w, D - dv0), width = min(W, (cols + 15) & ~15);
  const int n_fix = WHICH == 2 ? a.T : a.S, heads = WHICH == 2 ? a.Hkv : a.H, gq = a.H / a.Hkv;
  const int n_ft = (n_fix + FX - 1) / FX;
  const int f0 = rest % n_ft * FX, hh = rest / n_ft % heads, b = rest / (n_ft * heads);
  const int hk = WHICH == 2 ? hh : hh / gq;  // the kv head; the q head is hh (fwd / dq) or walk_head (dk/dv)
  const bool rot = a.rot.cos != nullptr, vec = a.vec != 0;
  const int rw = warp * 16 + g;  // this thread's fixed rows of the block: rw and rw + 8
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  // the walk: fwd / dq over kv_range, dk/dv over q_range for each q head of the group
  int lo, hi;
  if (WHICH == 2)
    q_range(a, f0, min(f0 + FX, n_fix) - 1, lo, hi);
  else
    kv_range(a, f0, min(f0 + FX, n_fix) - 1, lo, hi);
  const int n_wt = hi > lo ? (hi - lo + WK - 1) / WK : 0;
  const int total = (WHICH == 2 ? gq : 1) * n_wt * NK;  // steps: a chunk of a walked tile each
  auto walk_head = [&](int it) { return WHICH == 2 ? hk * gq + it / n_wt : hh; };
  auto walk_row0 = [&](int it) { return lo + it % n_wt * WK; };

  // step `step`: its chunk of every product's two operands into stage step & 1; at a tile's second
  // chunk also the tile's slices (the previous tile's C W products are done by then: D > 256, so NK > 1)
  auto issue = [&](int step) {
    const int it = step / NK, k = step - it * NK, col0 = k * KC, w0 = walk_row0(it);
    T* xs = sX + (step & 1) * NP * FX * ldc;
    T* ws = sW + (step & 1) * NP * WK * ldc;
    T* ss = sS;
    if constexpr (WHICH == 2) {
      const int h = walk_head(it);
      const T* qh = qb + h * a.q_sh;
      const T* doh = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
      wide_load<T, FX, KC>(xs, ldc, kb, a.k_ss, f0, a.T, col0, KC, D, vec, rot, a.rot, b);
      wide_load<T, FX, KC>(xs + FX * ldc, ldc, vb, a.v_ss, f0, a.T, col0, KC, D, vec, false, a.rot, b);
      wide_load<T, WK, KC>(ws, ldc, qh, a.q_ss, w0, a.S, col0, KC, D, vec, rot, a.rot, b);
      wide_load<T, WK, KC>(ws + WK * ldc, ldc, doh, a.do_ss, w0, a.S, col0, KC, D, vec, false, a.rot, b);
      if (k == 1) {
        wide_load<T, WK, W>(ss, lds, doh, a.do_ss, w0, a.S, dv0, width, D, vec, false, a.rot, b);
        wide_load<T, WK, W>(ss + WK * lds, lds, qh, a.q_ss, w0, a.S, dv0, width, D, vec, rot, a.rot, b);
      }
    } else {
      wide_load<T, FX, KC>(xs, ldc, qb + hh * a.q_sh, a.q_ss, f0, a.S, col0, KC, D, vec, rot, a.rot, b);
      wide_load<T, WK, KC>(ws, ldc, kb, a.k_ss, w0, a.T, col0, KC, D, vec, rot, a.rot, b);
      if (WHICH == 1) {
        const T* doh = static_cast<const T*>(a.dout) + b * a.do_sb + hh * a.do_sh;
        wide_load<T, FX, KC>(xs + FX * ldc, ldc, doh, a.do_ss, f0, a.S, col0, KC, D, vec, false, a.rot, b);
        wide_load<T, WK, KC>(ws + WK * ldc, ldc, vb, a.v_ss, w0, a.T, col0, KC, D, vec, false, a.rot, b);
      }
      if (k == 1) {
        if (WHICH == 0)
          wide_load<T, WK, W>(ss, lds, vb, a.v_ss, w0, a.T, dv0, width, D, vec, false, a.rot, b);
        else
          wide_load<T, WK, W>(ss, lds, kb, a.k_ss, w0, a.T, dv0, width, D, vec, rot, a.rot, b);
      }
    }
  };
  if (total > 0) issue(0);
  cp_commit();

  // the fixed rows' segment ids; dq: their LSE and delta; fwd: the online softmax's state
  int fix_id[2] = {0, 0};
  float lse[2] = {kNegInf, kNegInf}, dl[2] = {0.f, 0.f}, m_run[2], l[2] = {0.f, 0.f};
  m_run[0] = m_run[1] = -1e20f / a.c;
  const int64_t stat0 = (int64_t(b) * a.H + hh) * a.S;  // fwd / dq: the LSE and delta of head hh
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = f0 + rw + 8 * hr;
    if (a.seg_q != nullptr && r < n_fix)
      fix_id[hr] = WHICH == 2 ? a.seg_kv[int64_t(b) * a.T + r] : a.seg_q[int64_t(b) * a.S + r];
    if (WHICH == 1 && r < a.S) lse[hr] = a.lse[stat0 + r];
  }
  if constexpr (WHICH == 1) {
    // delta = rowsum(dO * O) of the warp's rows over the whole D, a lane for every 32nd column
    const T* ob = static_cast<const T*>(a.o) + b * a.o_sb + hh * a.o_sh;
    const T* doh = static_cast<const T*>(a.dout) + b * a.do_sb + hh * a.do_sh;
    const int lane = threadIdx.x & 31;
    for (int i = 0; i < 16; ++i) {
      const int r = f0 + warp * 16 + i;
      float part = 0.f;
      if (r < a.S)
        for (int d = lane; d < D; d += 32) part += to_f32(doh[r * a.do_ss + d]) * to_f32(ob[r * a.o_ss + d]);
#pragma unroll
      for (int o = 16; o; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (i == g) dl[0] = part;
      if (i == g + 8) dl[1] = part;
      if (slice == 0 && lane == 0 && r < a.S) a.delta[stat0 + r] = part;
    }
  }

  float out[NO][NC][4];
#pragma unroll
  for (int o = 0; o < NO; ++o)
#pragma unroll
    for (int n = 0; n < NC; ++n) out[o][n][0] = out[o][n][1] = out[o][n][2] = out[o][n][3] = 0.f;
  float s[SJ][4], dp[SJ][4];
  for (int step = 0; step < total; ++step) {
    const int it = step / NK, k = step - it * NK, st = step & 1;
    if (step + 1 < total) {
      __syncthreads();  // every warp is done with stage st ^ 1 and, at a tile's start, with the slices
      issue(step + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // step's chunks (and, from a tile's second chunk on, its slices) landed
    if (k == 0) {
#pragma unroll
      for (int j = 0; j < SJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
    const int kcols = min(KC, D - k * KC);
    const T* xs = sX + st * NP * FX * ldc + warp * 16 * ldc;
    const T* ws = sW + st * NP * WK * ldc;
    M::template product_nt<SJ>(s, xs, ws, ldc, kcols);
    if constexpr (NP == 2) M::template product_nt<SJ>(dp, xs + FX * ldc, ws + WK * ldc, ldc, kcols);
    if (k + 1 < NK) continue;

    // the tile's products are whole: p (and ds), then the C W products on its slices
    const int w0 = walk_row0(it);
    const T* ss = sS;
    if constexpr (WHICH == 0) {
      if (tile_masked(a, f0, w0, WK, false, FX)) {
#pragma unroll
        for (int j = 0; j < SJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hr = e >> 1, c = w0 + 8 * j + 2 * t4 + (e & 1);
            const int skv = a.seg_kv != nullptr && c < a.T ? a.seg_kv[int64_t(b) * a.T + c] : 0;
            if (!valid(a, f0 + rw + 8 * hr, c, fix_id[hr], skv)) s[j][e] = kNegInf;
          }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < SJ; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[hr], mx);
        const float mc = __fmul_rn(m_new, a.c), alpha = exp2f(__fmul_rn(m_run[hr], a.c) - mc);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < SJ; ++j)
#pragma unroll
          for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
            s[j][e] = exp2f(__fmul_rn(s[j][e], a.c) - mc);
            sum += s[j][e];
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[hr] = l[hr] * alpha + sum;
        m_run[hr] = m_new;
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          out[0][n][2 * hr] *= alpha;
          out[0][n][2 * hr + 1] *= alpha;
        }
      }
      M::template product_cw<SJ, NC>(out[0], s, ss, lds, cols);  // O += P V
    } else if constexpr (WHICH == 1) {
      const bool masked = tile_masked(a, f0, w0, WK, false, FX);
#pragma unroll
      for (int j = 0; j < SJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1, c = w0 + 8 * j + 2 * t4 + (e & 1);
          const int skv = a.seg_kv != nullptr && c < a.T ? a.seg_kv[int64_t(b) * a.T + c] : 0;
          const bool ok = lse[hr] > kNegInf / 2 && (!masked || valid(a, f0 + rw + 8 * hr, c, fix_id[hr], skv));
          const float p = ok ? exp2f(__fmul_rn(s[j][e], a.c) - lse[hr]) : 0.f;
          s[j][e] = __fmul_rn(__fmul_rn(dp[j][e] - dl[hr], p), a.scale);
        }
      M::template product_cw<SJ, NC>(out[0], s, ss, lds, cols);  // dQ += dS K
    } else {
      const int h = walk_head(it);
      const int64_t wstat = (int64_t(b) * a.H + h) * a.S;
      const bool masked = tile_masked(a, w0, f0, FX, false, WK);
#pragma unroll
      for (int j = 0; j < SJ; ++j)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int r = w0 + 8 * j + 2 * t4 + e2;  // the walked query row of columns e = e2 and e2 + 2
          const bool in = r < a.S;
          const float wl = in ? a.lse[wstat + r] : kNegInf, wd = in ? a.delta[wstat + r] : 0.f;
          const int wid = a.seg_q != nullptr && in ? a.seg_q[int64_t(b) * a.S + r] : 0;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int e = 2 * hr + e2;
            const bool ok = wl > kNegInf / 2 && (!masked || valid(a, r, f0 + rw + 8 * hr, wid, fix_id[hr]));
            const float p = ok ? exp2f(__fmul_rn(s[j][e], a.c) - wl) : 0.f;
            s[j][e] = p;
            dp[j][e] = __fmul_rn(__fmul_rn(dp[j][e] - wd, p), a.scale);
          }
        }
      M::template product_cw<SJ, NC>(out[0], s, ss, lds, cols);              // dV += P^T dO
      M::template product_cw<SJ, NC>(out[NO - 1], dp, ss + WK * lds, lds, cols);  // dK += dS^T Q
    }
  }
  cp_wait<0>();  // no copy is in flight at exit (a block with nothing to walk)

  // the slice of the outputs; with rotary, dq and dk in fp32 before the adjoint (wide_adjoint_kernel)
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = f0 + rw + 8 * hr;
    if (r >= n_fix) continue;
    if constexpr (WHICH == 2) {
      const int64_t at = ((int64_t(b) * a.T + r) * a.Hkv + hk) * D + dv0 + 2 * t4;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        if (n * 8 >= cols) break;
        store2(static_cast<T*>(a.dv) + at + n * 8, out[0][n][2 * hr], out[0][n][2 * hr + 1]);
        if (rot)
          store2(static_cast<float*>(a.dk) + at + n * 8, out[1][n][2 * hr], out[1][n][2 * hr + 1]);
        else
          store2(static_cast<T*>(a.dk) + at + n * 8, out[1][n][2 * hr], out[1][n][2 * hr + 1]);
      }
    } else {
      const int64_t at = ((int64_t(b) * a.S + r) * a.H + hh) * D + dv0 + 2 * t4;
      const bool dead = WHICH == 0 && l[hr] == 0.f;
      const float inv = WHICH == 0 && !dead ? l[hr] : 1.f;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        if (n * 8 >= cols) break;
        const float x = dead ? 0.f : out[0][n][2 * hr] / inv, y = dead ? 0.f : out[0][n][2 * hr + 1] / inv;
        if (WHICH == 0)
          store2(static_cast<T*>(a.out) + at + n * 8, x, y);
        else if (rot)
          store2(static_cast<float*>(a.dq) + at + n * 8, x, y);
        else
          store2(static_cast<T*>(a.dq) + at + n * 8, x, y);
      }
      if (WHICH == 0 && slice == 0 && t4 == 0)
        a.lse[stat0 + r] = dead ? kNegInf : __fmul_rn(m_run[hr], a.c) + log2f(l[hr]);
    }
  }
}

// The rotary adjoint of the wide dq (dk) with rotary: g [B, L, Hx, D] fp32,
// before the adjoint, into out (contiguous, of T) with store_adjoint's
// arithmetic, rounded as the plain version rounds. Not a TPU kernel: the
// Pallas kernels apply _rot_adjoint (:87) inside; here the partner column of
// NeoX halves may lie in another slice block.
template <typename T>
__global__ void __launch_bounds__(256) wide_adjoint_kernel(const float* g, T* out, int64_t n, int L, int Hx, int D,
                                                           Rot rot) {
  for (int64_t idx = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; idx < n; idx += int64_t(gridDim.x) * blockDim.x) {
    const int d = int(idx % D);
    const int64_t row = idx / D;
    const int pos = int(row / Hx % L), b = int(row / (int64_t(Hx) * L));
    float x = g[idx];
    if (d < 2 * rot.half) {
      const int64_t t = b * rot.sb + int64_t(pos) * D;
      const int p = partner(d, rot);
      const float y = __fmul_rn(g[idx - d + p], rot.sin[t + p]);
      x = __fadd_rn(__fmul_rn(x, rot.cos[t + d]), -rot_sign(d, rot) * y);
    }
    cast_store(out + idx, x);
  }
}

// ---- launches ------------------------------------------------------------------

template <typename T>
int wide_dispatch(int which, Args& a, int window, const void* rot_cos, const void* rot_sin, int64_t rot_sb,
                  int rot_half, int rot_interleaved, void* stream) {
  bool empty = false;
  const cudaError_t e =
      prepare(16 / sizeof(T), which, a, window, rot_cos, rot_sin, rot_sb, rot_half, rot_interleaved, empty, 0);
  if (e != cudaSuccess || empty) return int(e);
  if (a.D <= 256) return int(cudaErrorInvalidValue);  // flash_generic.cu's and flash_tf32.cu's head dims
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int W = which == 2 ? kWideSlice<2> : kWideSlice<0>;
  const int rows = which == 2 ? a.T : a.S, heads = which == 2 ? a.Hkv : a.H;
  const int blocks = (rows + kWideRows - 1) / kWideRows * heads * a.B * ((a.D + W - 1) / W);
  if (which == 0) return int(launch(wide_kernel<T, 0>, wide_bytes<T, 0>(), blocks, kWideThreads, a, s));
  if (which == 1) return int(launch(wide_kernel<T, 1>, wide_bytes<T, 1>(), blocks, kWideThreads, a, s));
  return int(launch(wide_kernel<T, 2>, wide_bytes<T, 2>(), blocks, kWideThreads, a, s));
}

template <typename T>
int wide_adjoint(const void* g, void* out, int B, int L, int Hx, int D, const void* rot_cos, const void* rot_sin,
                 int64_t rot_sb, int rot_half, int rot_interleaved, void* stream) {
  if (g == nullptr || out == nullptr || rot_cos == nullptr || rot_sin == nullptr || rot_half <= 0 ||
      2 * rot_half > D || B < 0 || L < 0 || Hx < 0)
    return int(cudaErrorInvalidValue);
  const int64_t n = int64_t(B) * L * Hx * D;
  if (n == 0) return 0;
  const Rot rot{static_cast<const float*>(rot_cos), static_cast<const float*>(rot_sin), rot_sb, rot_half,
                rot_interleaved};
  const int blocks = int((n + 255) / 256 < 132 * 16 ? (n + 255) / 256 : 132 * 16);
  wide_adjoint_kernel<T><<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(g),
                                                                               static_cast<T*>(out), n, L, Hx, D, rot);
  return int(cudaGetLastError());
}

}  // namespace

// q/k/v/O/dO/dq/dk/dv of one element type, bf16 or f32 (the argument lists:
// flash_generic_common.cuh). With rotary, dq (dk) is an fp32 buffer that
// takes the gradient before the adjoint; flash_wide_adjoint_* finishes it.
#define WIDE_ENTRY_POINTS(SUFFIX, T)                                                                          \
  extern "C" int flash_wide_fwd_##SUFFIX(FLASH_FWD_PARAMS) {                                                  \
    FLASH_FWD_ARGS(a);                                                                                        \
    return wide_dispatch<T>(0, a, window, rot_cos, rot_sin, rot_sb, rot_half, rot_interleaved, stream);       \
  }                                                                                                           \
  extern "C" int flash_wide_dq_##SUFFIX(FLASH_DQ_PARAMS) {                                                    \
    FLASH_DQ_ARGS(a);                                                                                         \
    return wide_dispatch<T>(1, a, window, rot_cos, rot_sin, rot_sb, rot_half, rot_interleaved, stream);       \
  }                                                                                                           \
  extern "C" int flash_wide_dkv_##SUFFIX(FLASH_DKV_PARAMS) {                                                  \
    FLASH_DKV_ARGS(a);                                                                                        \
    return wide_dispatch<T>(2, a, window, rot_cos, rot_sin, rot_sb, rot_half, rot_interleaved, stream);       \
  }                                                                                                           \
  /* g [B, L, Hx, D] fp32 -> out [B, L, Hx, D] of T, contiguous; rotary as the kernels' */                    \
  extern "C" int flash_wide_adjoint_##SUFFIX(const void* g, void* out, int B, int L, int Hx, int D,           \
                                             const void* rot_cos, const void* rot_sin, int64_t rot_sb,        \
                                             int rot_half, int rot_interleaved, void* stream) {               \
    return wide_adjoint<T>(g, out, B, L, Hx, D, rot_cos, rot_sin, rot_sb, rot_half, rot_interleaved, stream); \
  }

WIDE_ENTRY_POINTS(bf16, __nv_bfloat16)
WIDE_ENTRY_POINTS(f32, float)
