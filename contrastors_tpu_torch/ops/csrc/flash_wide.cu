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
// the whole head dim as the last dim of every block; here it does not fit:
// the DMAX-256 kernels keep each output row (O, dq, dk, dv) in registers and
// their operand tiles whole in shared memory, and above 256 neither fits.
//
// What every kernel here shares:
//   - the output's columns in slices, one block each: a block owns 64 fixed
//     rows (fwd / dq: query rows; dk/dv: kv rows) and the columns dv0 ..
//     dv0 + cols of their output; the slices of a head dim are of equal
//     width, a multiple of 8, but the last (D 320: 112, 112 and 96 in the
//     clusters, 2 x 160 in the forward);
//   - 4 warps own 16 fixed rows each and walk tiles of the other side (fwd /
//     dq: kv rows over kv_range; dk/dv: query rows over q_range, for every q
//     head of the GQA group); the C W products (P V, dS K, P^T dO, dS^T Q)
//     take p or ds straight from the accumulator registers;
//   - bf16: mma.sync.m16n8k16 (ldmatrix operands, tiles in rows of width + 8
//     elements: an odd multiple of 16 bytes); fp32: 3xTF32 on
//     mma.sync.m16n8k8 (flash_tf32.cu's note), tiles in rows of width + 4
//     floats;
//   - rows arrive by 16-byte cp.async where every operand's rows are 16-byte
//     aligned (Args.vec), else staged through registers, as are rotated q / k
//     tiles, whose partner column is read from device memory (it may lie in
//     another slice);
//   - the rotary adjoint on dq and dk needs g at the partner column, which
//     for NeoX halves may lie in another slice block: with rotary the dq and
//     dk/dv kernels store the fp32 gradient before its adjoint into a buffer
//     of the caller's, and wide_adjoint_kernel (not a TPU kernel: the pass
//     _rot_adjoint runs inside the Pallas kernels) applies store_adjoint's
//     arithmetic and the cast.
//
// The forward (wide_kernel<T, 0>), and the backward past a cluster's reach
// (wide_kernel<T, 1 / 2>, D > 1024): slices of at most 256 columns (O, dq)
// or 128 (dk with dv, which a warp holds both of); every slice block
// computes the whole S (and dP) itself, streaming both operands over D
// through shared memory in chunks of 64 columns in bf16, 32 in fp32 (two
// stages: the next chunk's copies run under this one's products), so that
// m, l, the LSE and delta agree bit for bit across the slices; slice 0
// writes the LSE (forward) and delta (dq), and each block loads its slice of
// the second product's operand (V; K; dO and Q) once a walked tile. Shared
// memory does not depend on D: 44-89 KB a block, two blocks an SM. The cost
// is the recomputation: a row tile's blocks work through slices x products
// over D, 2.5x the work of the products at D 512 in dk/dv, 1.67x in dq, and
// time followed that count (tools/generic_kernel_probe.py).
//
// The backward at 256 < D <= 1024 (wide_cluster_kernel<T, WHICH>): one
// thread-block cluster of n = ceil(D / 128) blocks (at most 8, the portable
// size) for every (batch, head, 64 fixed rows), the block of rank r owning
// slice r of the output's columns and of every operand's:
//   - its slices of the fixed rows' operands (dq: Q and dO; dk/dv: K and V)
//     stay in shared memory for the whole walk; for each walked tile it
//     streams only the tile's slices (dq: K and V; dk/dv: Q and dO), two
//     stages by cp.async, and the same slice feeds the block's share of S
//     and dP and its C W products: every operand element is loaded once;
//   - each block computes its share of S and dP (dk/dv: S^T, dP^T) over its
//     own columns on the tensor cores and stores it, fp32, into its shared
//     memory; after a cluster barrier (arrive.release / wait.acquire) every
//     block reads all n shares through distributed shared memory (mapa +
//     ld.shared::cluster) and sums them in rank order 0 .. n - 1, so every
//     block of the cluster holds the same S and dP bit for bit, and p and ds
//     follow as in the streamed design. A block overwrites its shares only
//     after every peer has read them: two buffers in bf16 (a peer that reads
//     tile i's shares has arrived at tile i + 1's barrier before this block
//     writes tile i + 2's), one in fp32 (an arrival after the reads, waited
//     on before the next write), which keeps two fp32 blocks an SM;
//   - dq: each block sums its share of delta = rowsum(dO * O) over its
//     columns (16-byte loads, two threads a row), the cluster adds the
//     shares in rank order and rank 0 writes delta for dk/dv;
//   - the walk range depends only on the fixed rows, so every block of a
//     cluster takes the same barriers; each ends with a cluster barrier, so
//     that none leaves while a peer may still read its shared memory;
//   - walked tiles of 32 rows (bf16 dk/dv: 255 registers and 100 KB, two
//     blocks an SM) or 16 (bf16 dq: 168 registers and 67 KB, three blocks
//     an SM, 12% faster than 32 rows in turns; fp32: 107 KB, two blocks).
// Past 8 blocks (D > 1024) the head dim takes the streamed design above, a
// route by shape.
//
// What bounds them on an H100: latency. At the main path's shapes
// (pythia-1b's width read as 4 heads of 512: 128-token rows, causal) a block
// walks 2-4 tiles; each waits on its copies and, in the clusters, on its
// peers' shares, with two or three 4-warp blocks an SM to cover the waits.
// The backward reaches 0.17-0.21 of its byte bound, the forward 0.14-0.16.
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
  // acc += X W^T over the first kcols of KC columns (past them, zero up to
  // a multiple of 16): X the warp's 16 rows at x, W the walked tile at w
  template <int SJ, int KC = kChunk>
  static __device__ __forceinline__ void product_nt(float (&acc)[SJ][4], const bf16* x, const bf16* w, int ld,
                                                    int kcols) {
    const int lane = threadIdx.x & 31;
    const uint32_t xa = smem_addr(x + a_row(lane) * ld + a_col(lane));
    const uint32_t wa = smem_addr(w + bn_row(lane) * ld + bn_col(lane));
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
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
  template <int SJ, int KC = kChunk>
  static __device__ __forceinline__ void product_nt(float (&acc)[SJ][4], const float* x, const float* w, int ld,
                                                    int kcols) {
    constexpr int G = SJ < 4 ? SJ : 4;  // walked 8-row groups a pass
    const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
    const float* xf = x + g * ld + t4;
    const float* wf = w + g * ld + t4;
    auto& acc1 = reinterpret_cast<float(&)[1][SJ][4]>(acc);
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk) {
      if (kk * 8 >= kcols) break;
      uint32_t ab[1][4], as[1][4];
      a_frag(xf + kk * 8, ld, ab[0], as[0]);
#pragma unroll
      for (int j0 = 0; j0 < SJ; j0 += G) {
        uint32_t bb[G][2], bs[G][2];
#pragma unroll
        for (int i = 0; i < G; ++i) {
          const float* wr = wf + (j0 + i) * 8 * ld + kk * 8;
          split_tf32_fast(wr[0], bb[i][0], bs[i][0]);
          split_tf32_fast(wr[4], bb[i][1], bs[i][1]);
        }
        mma_3xtf32<1, SJ, G>(acc1, j0, ab, as, bb, bs, G);
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
// n_valid and in columns past D or lim. By 16-byte cp.async when `async`, else
// staged through registers, rotated (q, k) as the plain version rotates when
// `rotate`: the partner column is read from device memory.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void wide_load(T* dst, int ld, const T* base, int64_t ss, int row0, int n_valid, int col0,
                                          int width, int D, bool async, bool rotate, const Rot& rot, int b,
                                          int lim = 1 << 30) {
  if (async && !rotate) {
    constexpr int EPS = 16 / sizeof(T), SLOTS = COLS / EPS;  // elements of a 16-byte slot; slots of a row
    for (int idx = threadIdx.x; idx < ROWS * SLOTS; idx += kWideThreads) {
      const int r = idx / SLOTS, c = (idx - r * SLOTS) * EPS, pos = row0 + r, d = col0 + c;
      if (c >= width) continue;
      const bool ok = pos < n_valid && d < D && d < lim;
      cp_async16(smem_addr(dst + r * ld + c), ok ? base + int64_t(pos) * ss + d : base, ok);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < ROWS * COLS; idx += kWideThreads) {
    const int r = idx / COLS, c = idx - r * COLS, pos = row0 + r, d = col0 + c;
    if (c >= width) continue;
    float x = 0.f;
    if (pos < n_valid && d < D && d < lim) {
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

// The backward's step from a walked tile's whole S and dP to what its C W
// products take, for a warp's 16 fixed rows rw - rw % 16 .. of f0 and the
// walked rows w0 .. w0 + 8 SJ, in the accumulators' layout.
// dq: S and dP of query rows against kv rows -> dS (into s), from the fixed
// rows' LSE and delta
template <int SJ>
__device__ __forceinline__ void tile_ds(float (&s)[SJ][4], const float (&dp)[SJ][4], const Args& a, int b, int f0,
                                        int w0, int rw, const int (&fix_id)[2], const float (&lse)[2],
                                        const float (&dl)[2]) {
  const int t4 = threadIdx.x & 3;
  const bool masked = tile_masked(a, f0, w0, 8 * SJ, false, kWideRows);
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
}

// dk/dv: S^T and dP^T of kv rows against the query rows of q head h -> P^T
// (into s) and dS^T (into dp), from the walked rows' LSE and delta
template <int SJ>
__device__ __forceinline__ void tile_p_ds(float (&s)[SJ][4], float (&dp)[SJ][4], const Args& a, int b, int h, int f0,
                                          int w0, int rw, const int (&fix_id)[2]) {
  const int t4 = threadIdx.x & 3;
  const int64_t wstat = (int64_t(b) * a.H + h) * a.S;
  const bool masked = tile_masked(a, w0, f0, kWideRows, false, 8 * SJ);
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
}

// The backward's slice of its outputs, columns dv0 .. dv0 + cols, at this
// thread's fixed rows f0 + rw and f0 + rw + 8; with rotary, dq and dk in fp32
// before the adjoint (wide_adjoint_kernel).
// dq of q head hh
template <typename T, int NC>
__device__ __forceinline__ void store_dq(const Args& a, const float (&dq)[NC][4], int b, int hh, int f0, int rw,
                                         int dv0, int cols, bool rot) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = f0 + rw + 8 * hr;
    if (r >= a.S) continue;
    const int64_t at = ((int64_t(b) * a.S + r) * a.H + hh) * a.D + dv0 + 2 * t4;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      if (n * 8 >= cols) break;
      if (rot)
        store2(static_cast<float*>(a.dq) + at + n * 8, dq[n][2 * hr], dq[n][2 * hr + 1]);
      else
        store2(static_cast<T*>(a.dq) + at + n * 8, dq[n][2 * hr], dq[n][2 * hr + 1]);
    }
  }
}
// dv and dk of kv head hk
template <typename T, int NC>
__device__ __forceinline__ void store_dkv(const Args& a, const float (&dv)[NC][4], const float (&dk)[NC][4], int b,
                                          int hk, int f0, int rw, int dv0, int cols, bool rot) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = f0 + rw + 8 * hr;
    if (r >= a.T) continue;
    const int64_t at = ((int64_t(b) * a.T + r) * a.Hkv + hk) * a.D + dv0 + 2 * t4;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      if (n * 8 >= cols) break;
      store2(static_cast<T*>(a.dv) + at + n * 8, dv[n][2 * hr], dv[n][2 * hr + 1]);
      if (rot)
        store2(static_cast<float*>(a.dk) + at + n * 8, dk[n][2 * hr], dk[n][2 * hr + 1]);
      else
        store2(static_cast<T*>(a.dk) + at + n * 8, dk[n][2 * hr], dk[n][2 * hr + 1]);
    }
  }
}

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
      tile_ds<SJ>(s, dp, a, b, f0, w0, rw, fix_id, lse, dl);
      M::template product_cw<SJ, NC>(out[0], s, ss, lds, cols);  // dQ += dS K
    } else {
      tile_p_ds<SJ>(s, dp, a, b, walk_head(it), f0, w0, rw, fix_id);
      M::template product_cw<SJ, NC>(out[0], s, ss, lds, cols);              // dV += P^T dO
      M::template product_cw<SJ, NC>(out[NO - 1], dp, ss + WK * lds, lds, cols);  // dK += dS^T Q
    }
  }
  cp_wait<0>();  // no copy is in flight at exit (a block with nothing to walk)

  // the slice of the outputs
  if constexpr (WHICH == 2) {
    store_dkv<T, NC>(a, out[0], out[NO - 1], b, hk, f0, rw, dv0, cols, rot);
  } else if constexpr (WHICH == 1) {
    store_dq<T, NC>(a, out[0], b, hh, f0, rw, dv0, cols, rot);
  } else {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = f0 + rw + 8 * hr;
      if (r >= n_fix) continue;
      const int64_t at = ((int64_t(b) * a.S + r) * a.H + hh) * D + dv0 + 2 * t4;
      const bool dead = l[hr] == 0.f;
      const float inv = !dead ? l[hr] : 1.f;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        if (n * 8 >= cols) break;
        const float x = dead ? 0.f : out[0][n][2 * hr] / inv, y = dead ? 0.f : out[0][n][2 * hr + 1] / inv;
        store2(static_cast<T*>(a.out) + at + n * 8, x, y);
      }
      if (slice == 0 && t4 == 0) a.lse[stat0 + r] = dead ? kNegInf : __fmul_rn(m_run[hr], a.c) + log2f(l[hr]);
    }
  }
}

// ---- the wide dq and dk/dv in thread-block clusters (256 < D <= 1024) ---------

constexpr int kClusterSlice = 128;  // the widest output slice of a cluster block, and of its operands' slices
constexpr int kClusterMax = 8;      // the portable cluster size: D up to 8 x 128

// walked rows a tile and buffers of partial products (dq: WHICH 1, dk/dv: 2)
template <typename T, int WHICH>
struct ClusterCfg {  // bf16 dk/dv: 32-row tiles, two blocks an SM (255 registers)
  static constexpr int kWalk = 32, kBufs = 2;
};
template <>
struct ClusterCfg<bf16, 1> {  // bf16 dq: 16-row tiles, 67 KB, three blocks an SM (168 registers)
  static constexpr int kWalk = 16, kBufs = 2;
};
template <int WHICH>
struct ClusterCfg<float, WHICH> {  // 16-row tiles, one buffer: two blocks an SM in shared memory
  static constexpr int kWalk = 16, kBufs = 1;
};
constexpr int kClusterStages = 2;  // stages of walked tiles: the next tile's copies run under this one's products

template <typename T, int WHICH>
size_t cluster_bytes() {
  using C = ClusterCfg<T, WHICH>;
  constexpr int ld = kClusterSlice + WideMma<T>::kPad;
  return size_t(2 * kWideRows + kClusterStages * 2 * C::kWalk) * ld * sizeof(T) +
         (size_t(C::kBufs) * 2 * kWideRows * C::kWalk + (WHICH == 1 ? kWideRows : 0)) * sizeof(float);
}

// 8 elements at p (16-byte aligned rows when vec) as fp32
__device__ __forceinline__ void load8(const bf16* p, float (&x)[8], bool vec) {
  if (vec) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = __bfloat162float(h[e]);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = __bfloat162float(p[e]);
  }
}
__device__ __forceinline__ void load8(const float* p, float (&x)[8], bool vec) {
  if (vec) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(p)), w = __ldg(reinterpret_cast<const float4*>(p) + 1);
    x[0] = u.x, x[1] = u.y, x[2] = u.z, x[3] = u.w, x[4] = w.x, x[5] = w.y, x[6] = w.z, x[7] = w.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = p[e];
  }
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return int(r);
}
// the cluster's barrier: this block's shared-memory writes before the arrival are seen by every
// peer after its wait
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.release;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory"); }
// p's shared-memory address in the cluster's block of rank r
__device__ __forceinline__ uint32_t peer_addr(const float* p, int r) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(addr) : "r"(smem_addr(p)), "r"(r));
  return addr;
}
__device__ __forceinline__ float ld_peer(const float* p, int r) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(peer_addr(p, r)) : "memory");
  return v;
}
__device__ __forceinline__ float4 ld_peer4(const float* p, int r) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(peer_addr(p, r))
               : "memory");
  return v;
}

// s and dp, a thread's accumulators, replaced by their sums over the cluster's
// n blocks in rank order 0 .. n - 1; each block's share lies at ps / pd (in
// every block the same offsets: slot j at + 128 j floats), so every block
// gets the same bits
template <int SJ>
__device__ __forceinline__ void cluster_sum(float (&s)[SJ][4], float (&dp)[SJ][4], const float* ps, const float* pd,
                                            int n) {
#pragma unroll
  for (int j = 0; j < SJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
  for (int r = 0; r < n; ++r) {
    float4 vs[SJ], vd[SJ];
#pragma unroll
    for (int j = 0; j < SJ; ++j) {
      vs[j] = ld_peer4(ps + 128 * j, r);
      vd[j] = ld_peer4(pd + 128 * j, r);
    }
#pragma unroll
    for (int j = 0; j < SJ; ++j) {
      s[j][0] += vs[j].x, s[j][1] += vs[j].y, s[j][2] += vs[j].z, s[j][3] += vs[j].w;
      dp[j][0] += vd[j].x, dp[j][1] += vd[j].y, dp[j][2] += vd[j].z, dp[j][3] += vd[j].w;
    }
  }
}

// The wide dq (WHICH 1) and dk/dv (2) for 256 < D <= 1024 in T (bf16 or
// fp32): one cluster of n = ceil(D / 128) blocks per (batch, head, 64 fixed
// rows); the block of rank r owns slice r of the output's columns and of every
// operand's, and computes its share of S and dP (S^T, dP^T) over those columns
// only; the cluster sums the shares through distributed shared memory.
template <typename T, int WHICH>
__global__ void __launch_bounds__(kWideThreads) wide_cluster_kernel(Args a) {
  using M = WideMma<T>;
  using C = ClusterCfg<T, WHICH>;
  constexpr int W = kClusterSlice, NC = W / 8, FX = kWideRows, WK = C::kWalk, SJ = WK / 8;
  constexpr int NO = kWideOutputs<WHICH>, ld = W + M::kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sX = reinterpret_cast<T*>(smem_raw);  // [2][FX][ld]: the fixed rows' slices (dq: Q, dO; dk/dv: K, V)
  T* sW = sX + 2 * FX * ld;                // [kClusterStages][2][WK][ld]: the walked tile's (dq: K, V; dk/dv: Q, dO)
  // [kBufs][2 (S, dP)][4 warps][SJ][32 lanes][4]: the block's shares, in the accumulators' order
  float* sP = reinterpret_cast<float*>(sW + kClusterStages * 2 * WK * ld);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int D = a.D, n = (D + W - 1) / W, slice_w = ((D + n - 1) / n + 7) / 8 * 8;
  const int rank = cluster_rank(), rest = blockIdx.x / n;
  const int dv0 = rank * slice_w, cols = min(slice_w, D - dv0), width = min(W, (cols + 15) & ~15);
  const int lim = dv0 + cols;  // past it, the next block's columns: zero in this block's tiles
  const int n_fix = WHICH == 2 ? a.T : a.S, heads = WHICH == 2 ? a.Hkv : a.H, gq = a.H / a.Hkv;
  const int n_ft = (n_fix + FX - 1) / FX;
  const int f0 = rest % n_ft * FX, hh = rest / n_ft % heads, b = rest / (n_ft * heads);
  const int hk = WHICH == 2 ? hh : hh / gq;  // the kv head; the q head is hh (dq) or walk_head (dk/dv)
  const bool rot = a.rot.cos != nullptr, vec = a.vec != 0;
  const int rw = warp * 16 + g;  // this thread's fixed rows of the block: rw and rw + 8
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  // the walk, as in wide_kernel: the same in every block of the cluster, so all take the same barriers
  int lo, hi;
  if (WHICH == 2)
    q_range(a, f0, min(f0 + FX, n_fix) - 1, lo, hi);
  else
    kv_range(a, f0, min(f0 + FX, n_fix) - 1, lo, hi);
  const int n_wt = hi > lo ? (hi - lo + WK - 1) / WK : 0;
  const int total = (WHICH == 2 ? gq : 1) * n_wt;
  auto walk_head = [&](int it) { return WHICH == 2 ? hk * gq + it / n_wt : hh; };
  auto walk_row0 = [&](int it) { return lo + it % n_wt * WK; };

  // walked tile `it`: its slices into stage it % 2
  auto issue = [&](int it) {
    const int w0 = walk_row0(it);
    T* ws = sW + (it & 1) * 2 * WK * ld;
    if constexpr (WHICH == 2) {
      const int h = walk_head(it);
      const T* doh = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
      wide_load<T, WK, W>(ws, ld, qb + h * a.q_sh, a.q_ss, w0, a.S, dv0, width, D, vec, rot, a.rot, b, lim);
      wide_load<T, WK, W>(ws + WK * ld, ld, doh, a.do_ss, w0, a.S, dv0, width, D, vec, false, a.rot, b, lim);
    } else {
      wide_load<T, WK, W>(ws, ld, kb, a.k_ss, w0, a.T, dv0, width, D, vec, rot, a.rot, b, lim);
      wide_load<T, WK, W>(ws + WK * ld, ld, vb, a.v_ss, w0, a.T, dv0, width, D, vec, false, a.rot, b, lim);
    }
  };
  if constexpr (WHICH == 2) {
    wide_load<T, FX, W>(sX, ld, kb, a.k_ss, f0, a.T, dv0, width, D, vec, rot, a.rot, b, lim);
    wide_load<T, FX, W>(sX + FX * ld, ld, vb, a.v_ss, f0, a.T, dv0, width, D, vec, false, a.rot, b, lim);
  } else {
    const T* doh = static_cast<const T*>(a.dout) + b * a.do_sb + hh * a.do_sh;
    wide_load<T, FX, W>(sX, ld, qb + hh * a.q_sh, a.q_ss, f0, a.S, dv0, width, D, vec, rot, a.rot, b, lim);
    wide_load<T, FX, W>(sX + FX * ld, ld, doh, a.do_ss, f0, a.S, dv0, width, D, vec, false, a.rot, b, lim);
  }
  if (total > 0) issue(0);
  cp_commit();

  // the fixed rows' segment ids; dq: their LSE and delta
  int fix_id[2] = {0, 0};
  float lse[2] = {kNegInf, kNegInf}, dl[2] = {0.f, 0.f};
  const int64_t stat0 = (int64_t(b) * a.H + hh) * a.S;  // dq: the LSE and delta of head hh
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = f0 + rw + 8 * hr;
    if (a.seg_q != nullptr && r < n_fix)
      fix_id[hr] = WHICH == 2 ? a.seg_kv[int64_t(b) * a.T + r] : a.seg_q[int64_t(b) * a.S + r];
    if (WHICH == 1 && r < a.S) lse[hr] = a.lse[stat0 + r];
  }
  if constexpr (WHICH == 1) {
    // delta = rowsum(dO * O): the block's share over its columns, two threads a row, each over every
    // other 8 columns (16-byte loads where rows are aligned), then the cluster's sum in rank order;
    // rank 0 writes it for dk/dv
    const T* ob = static_cast<const T*>(a.o) + b * a.o_sb + hh * a.o_sh;
    const T* doh = static_cast<const T*>(a.dout) + b * a.do_sb + hh * a.do_sh;
    float* sD = sP + C::kBufs * 2 * FX * WK;  // [FX] the block's share
    const int row = f0 + (threadIdx.x >> 1);
    float part = 0.f;
    if (row < a.S) {
      const T* dor = doh + row * a.do_ss + dv0;
      const T* orow = ob + row * a.o_ss + dv0;
#pragma unroll
      for (int i = 0; i < W / 16; ++i) {
        const int c = 16 * i + 8 * (threadIdx.x & 1);
        if (c < cols) {
          float x[8], y[8];
          load8(dor + c, x, vec);
          load8(orow + c, y, vec);
#pragma unroll
          for (int e = 0; e < 8; ++e) part += x[e] * y[e];
        }
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if ((threadIdx.x & 1) == 0) sD[threadIdx.x >> 1] = part;
    cluster_arrive();
    cluster_wait();
    for (int r = 0; r < n; ++r) {
      dl[0] += ld_peer(sD + rw, r);
      dl[1] += ld_peer(sD + rw + 8, r);
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      if (rank == 0 && t4 == 0 && f0 + rw + 8 * hr < a.S) a.delta[stat0 + f0 + rw + 8 * hr] = dl[hr];
  }

  float out[NO][NC][4];
#pragma unroll
  for (int o = 0; o < NO; ++o)
#pragma unroll
    for (int c = 0; c < NC; ++c) out[o][c][0] = out[o][c][1] = out[o][c][2] = out[o][c][3] = 0.f;
  float s[SJ][4], dp[SJ][4];
  bool pending = false;  // one buffer: this block's arrival after reading its peers' shares, not yet waited on
  for (int it = 0; it < total; ++it) {
    if (it + 1 < total) {
      __syncthreads();  // every warp is done with stage (it + 1) % 2
      issue(it + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // tile it's slices landed
    const T* ws = sW + (it & 1) * 2 * WK * ld;
#pragma unroll
    for (int j = 0; j < SJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    // the block's shares of S = X W^T and dP over its columns (dk/dv: S^T = K Q^T, dP^T = V dO^T)
    M::template product_nt<SJ, W>(s, sX + warp * 16 * ld, ws, ld, cols);
    M::template product_nt<SJ, W>(dp, sX + (FX + warp * 16) * ld, ws + WK * ld, ld, cols);
    float* ps = sP + (it % C::kBufs) * 2 * FX * WK + (warp * SJ * 32 + lane) * 4;
    float* pd = ps + FX * WK;
    if (pending) cluster_wait();  // every peer has read this buffer's last shares
#pragma unroll
    for (int j = 0; j < SJ; ++j) {
      *reinterpret_cast<float4*>(ps + 128 * j) = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
      *reinterpret_cast<float4*>(pd + 128 * j) = make_float4(dp[j][0], dp[j][1], dp[j][2], dp[j][3]);
    }
    cluster_arrive();
    cluster_wait();  // every block's shares of this tile are written
    cluster_sum<SJ>(s, dp, ps, pd, n);
    if constexpr (C::kBufs == 1) {
      cluster_arrive();
      pending = true;
    }

    // the tile's S and dP are whole: p and ds, then the C W products on the block's slices
    const int w0 = walk_row0(it);
    if constexpr (WHICH == 1) {
      tile_ds<SJ>(s, dp, a, b, f0, w0, rw, fix_id, lse, dl);
      M::template product_cw<SJ, NC>(out[0], s, ws, ld, cols);  // dQ += dS K
    } else {
      tile_p_ds<SJ>(s, dp, a, b, walk_head(it), f0, w0, rw, fix_id);
      M::template product_cw<SJ, NC>(out[0], s, ws + WK * ld, ld, cols);  // dV += P^T dO
      M::template product_cw<SJ, NC>(out[1], dp, ws, ld, cols);           // dK += dS^T Q
    }
  }
  cp_wait<0>();  // no copy is in flight at exit (a block with nothing to walk)
  // no block leaves while a peer may still read its shared memory
  if (!pending) cluster_arrive();
  cluster_wait();

  if constexpr (WHICH == 2)
    store_dkv<T, NC>(a, out[0], out[1], b, hk, f0, rw, dv0, cols, rot);
  else
    store_dq<T, NC>(a, out[0], b, hh, f0, rw, dv0, cols, rot);
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
  const int rows = which == 2 ? a.T : a.S, heads = which == 2 ? a.Hkv : a.H;
  const int tiles = (rows + kWideRows - 1) / kWideRows * heads * a.B;
  const int n = (a.D + kClusterSlice - 1) / kClusterSlice;  // the backward's cluster size
  if (which == 1 && n <= kClusterMax)
    return int(launch(wide_cluster_kernel<T, 1>, cluster_bytes<T, 1>(), tiles * n, kWideThreads, a, s, n));
  if (which == 2 && n <= kClusterMax)
    return int(launch(wide_cluster_kernel<T, 2>, cluster_bytes<T, 2>(), tiles * n, kWideThreads, a, s, n));
  const int W = which == 2 ? kWideSlice<2> : kWideSlice<0>;
  const int blocks = tiles * ((a.D + W - 1) / W);
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
