// What the generic flash kernels share: flash_generic.cu (bf16 at every head
// dim up to 256 the Hopper kernels do not take), flash_tf32.cu (fp32 up to
// 256) and flash_wide.cu (both dtypes above 256). The arguments, the masks,
// the rotary on load and its adjoint before the store, the kv / q ranges that
// a block can see, the asynchronous copies and the tensor-core helpers.
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

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
};
template <>
struct Elem<__nv_bfloat16> {
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

// The adjoint of the rotation on an fp32 tile g[r * (D + 1) + d] of rows at
// sequence positions row0 + r, cast to T and stored at out + pos * ss: g * cos
// + rot^T(g * sin), rounded as the plain version rounds (rot^T = -rot).
template <typename T, int NT = 256>
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

// whether rows [r0, r0 + rows) against columns [c0, c0 + cols) need the
// element-wise mask: segments (unless `one_segment`: every key of the tile
// holds the one nonzero id of the block's rows, whose rows with id 0 the
// caller treats as empty), columns past T, or a causal / window edge
// crossing the tile (rows past S are dropped or carry a -1e30 LSE)
__device__ __forceinline__ bool tile_masked(const Args& a, int r0, int c0, int cols = 64, bool one_segment = false,
                                            int rows = 64) {
  const int r1 = r0 + rows - 1, c1 = c0 + cols - 1;
  return (a.seg_q != nullptr && !one_segment) || c1 >= a.T || (a.causal && c1 > r0 + a.causal_offset) ||
         (a.w2 >= 0 && (c0 < r1 - a.w2 || c1 > r0 + a.w2));
}

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

// `cluster` > 1 launches thread-block clusters of that many consecutive
// blocks (flash_wide.cu's backward); a refused launch returns its error
template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, int blocks, int threads, const Args& a, cudaStream_t s,
                   int cluster = 1) {
  const int bytes = int(smem);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  if (blocks == 0) return cudaSuccess;
  if (cluster == 1) {
    kernel<<<blocks, threads, bytes, s>>>(a);
    return cudaGetLastError();
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// a base pointer and (batch, sequence, head) strides that keep every row
// 16-byte aligned; `per16` elements make 16 bytes
bool rows_aligned(const void* p, int64_t sb, int64_t ss, int64_t sh, int per16) {
  return p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % per16 == 0 && ss % per16 == 0 &&
         sh % per16 == 0;
}

// Checks what every generic kernel takes (D % 8 == 0 up to max_d, no limit
// where max_d is 0; Hkv dividing H, a rotary dim within D) and completes a:
// the window, whether every row is 16-byte aligned (per16 elements make 16
// bytes), the rotary tables. `empty`: nothing to launch. which: 0 forward, 1
// dq, 2 dk/dv.
cudaError_t prepare(int per16, int which, Args& a, int window, const void* rot_cos, const void* rot_sin,
                    int64_t rot_sb, int rot_half, int rot_interleaved, bool& empty, int max_d) {
  if (a.Hkv <= 0 || a.H % a.Hkv != 0 || a.D % 8 != 0 || a.D < 8 || (max_d > 0 && a.D > max_d) ||
      (rot_cos != nullptr && (rot_half <= 0 || 2 * rot_half > a.D)))
    return cudaErrorInvalidValue;
  empty = a.B == 0 || a.S == 0 || a.H == 0;
  a.w2 = window > 0 ? window / 2 : -1;
  a.vec = rows_aligned(a.q, a.q_sb, a.q_ss, a.q_sh, per16) && rows_aligned(a.k, a.k_sb, a.k_ss, a.k_sh, per16) &&
          rows_aligned(a.v, a.v_sb, a.v_ss, a.v_sh, per16) &&
          (which == 0 || rows_aligned(a.dout, a.do_sb, a.do_ss, a.do_sh, per16)) &&
          (which != 1 || rows_aligned(a.o, a.o_sb, a.o_ss, a.o_sh, per16));
  a.rot = Rot{static_cast<const float*>(rot_cos), static_cast<const float*>(rot_sin), rot_sb, rot_half,
              rot_interleaved};
  return cudaSuccess;
}

}  // namespace

// ---- tensor-core helpers (mma.sync), for every file that includes this ----------
// Outside the anonymous namespace: each library uses a subset, and an unused
// function of internal linkage would draw a compiler warning.

// ldmatrix: four 8 x 8 b16 matrices, and their transposes
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

// The 3xTF32 split of the fp32 backward and wide kernels, in 3 instructions
// where flash_tf32.cu's split_tf32 takes 5: big is x's bits plus half a TF32
// ulp, which mma.sync truncates to TF32's 19 bits, so that the product reads
// rna_tf32(x); small = x - rna_tf32(x), exact, which mma.sync truncates in
// turn (within 2^-10 of small, against 2^-11 rounded)
__device__ __forceinline__ void split_tf32_fast(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) + 0x1000u;
  small = __float_as_uint(x - __uint_as_float(big & 0xffffe000u));
}

// the A fragment (big, small) of one k step of a 16-row m tile of an fp32
// tile: x at the thread's row g, column t (row g + 8 at x + 8 ld)
__device__ __forceinline__ void a_frag(const float* x, int ld, uint32_t (&ab)[4], uint32_t (&as)[4]) {
  split_tf32_fast(x[0], ab[0], as[0]);
  split_tf32_fast(x[8 * ld], ab[1], as[1]);
  split_tf32_fast(x[4], ab[2], as[2]);
  split_tf32_fast(x[8 * ld + 4], ab[3], as[3]);
}

// out[m][n] += C W in 3xTF32: C the accumulators c[m][j] of an X W^T (MT m
// tiles x SJ k steps of 8 walked rows: columns 2t, 2t + 1 are the k slots t,
// t + 4), W the walked tile over `cols` columns (wk: its row 2t, column g; at
// most NC n tiles); C's fragments split once for the n tiles, W's once for
// the MT m tiles
template <int MT, int SJ, int NC>
__device__ __forceinline__ void product_cw(float (&out)[MT][NC][4], const float (&c)[MT][SJ][4], const float* wk,
                                           int ld, int cols) {
  constexpr int GP = 4;
  static_assert(NC % GP == 0, "n tiles go GP at a time");
#pragma unroll
  for (int j = 0; j < SJ; ++j) {
    uint32_t ab[MT][4], as[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      split_tf32_fast(c[m][j][0], ab[m][0], as[m][0]);
      split_tf32_fast(c[m][j][2], ab[m][1], as[m][1]);
      split_tf32_fast(c[m][j][1], ab[m][2], as[m][2]);
      split_tf32_fast(c[m][j][3], ab[m][3], as[m][3]);
    }
    const float* wj = wk + 8 * j * ld;
#pragma unroll
    for (int n0 = 0; n0 < NC; n0 += GP) {
      if (n0 * 8 >= cols) break;
      const int live = min(GP, (cols >> 3) - n0);
      uint32_t bb[GP][2], bs[GP][2];
#pragma unroll
      for (int i = 0; i < GP; ++i)
        if (i < live) {
          split_tf32_fast(wj[(n0 + i) * 8], bb[i][0], bs[i][0]);
          split_tf32_fast(wj[ld + (n0 + i) * 8], bb[i][1], bs[i][1]);
        }
      mma_3xtf32<MT, NC, GP>(out, n0, ab, as, bb, bs, live);
    }
  }
}

// The C entry points' argument lists, and the Args they fill. dtype-free: each
// library takes one element type. Outputs are contiguous [B, S, H, D] (O, dq),
// [B, T, Hkv, D] (dk, dv) and [B, H, S] fp32 (LSE, delta); inputs take any
// batch, sequence and head strides with a unit stride over D.
#define FLASH_FWD_PARAMS                                                                                           \
  const void *q, const void *k, const void *v, void *o, void *lse, const void *seg_q, const void *seg_kv, int B,    \
      int S, int T, int H, int Hkv, int D, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,   \
      int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, int causal, int causal_offset, int window, float c, \
      const void *rot_cos, const void *rot_sin, int64_t rot_sb, int rot_half, int rot_interleaved, void *stream
#define FLASH_DQ_PARAMS                                                                                            \
  const void *q, const void *k, const void *v, const void *dout, const void *o, const void *lse, void *delta,      \
      void *dq, const void *seg_q, const void *seg_kv, int B, int S, int T, int H, int Hkv, int D, int64_t q_sb,   \
      int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,            \
      int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh, int64_t do_sb, int64_t do_ss, int64_t do_sh,         \
      int causal, int causal_offset, int window, float c, float scale, const void *rot_cos, const void *rot_sin,   \
      int64_t rot_sb, int rot_half, int rot_interleaved, void *stream
#define FLASH_DKV_PARAMS                                                                                           \
  const void *q, const void *k, const void *v, const void *dout, const void *lse, const void *delta, void *dk,     \
      void *dv, const void *seg_q, const void *seg_kv, int B, int S, int T, int H, int Hkv, int D, int64_t q_sb,   \
      int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,            \
      int64_t v_sh, int64_t do_sb, int64_t do_ss, int64_t do_sh, int causal, int causal_offset, int window,        \
      float c, float scale, const void *rot_cos, const void *rot_sin, int64_t rot_sb, int rot_half,               \
      int rot_interleaved, void *stream

#define FLASH_FWD_ARGS(a)                                                                         \
  Args a = {};                                                                                   \
  a.q = q; a.k = k; a.v = v; a.out = o; a.lse = static_cast<float*>(lse);                       \
  a.seg_q = static_cast<const int*>(seg_q); a.seg_kv = static_cast<const int*>(seg_kv);         \
  a.B = B; a.S = S; a.T = T; a.H = H; a.Hkv = Hkv; a.D = D;                                      \
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh; a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;      \
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;                                                   \
  a.causal = causal; a.causal_offset = causal_offset; a.c = c
#define FLASH_DQ_ARGS(a)                                                                                    \
  Args a = {};                                                                                             \
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.o = o;                                                       \
  a.lse = const_cast<float*>(static_cast<const float*>(lse)); a.delta = static_cast<float*>(delta); a.dq = dq; \
  a.seg_q = static_cast<const int*>(seg_q); a.seg_kv = static_cast<const int*>(seg_kv);                   \
  a.B = B; a.S = S; a.T = T; a.H = H; a.Hkv = Hkv; a.D = D;                                                \
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh; a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;                \
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh; a.o_sb = o_sb; a.o_ss = o_ss; a.o_sh = o_sh;                \
  a.do_sb = do_sb; a.do_ss = do_ss; a.do_sh = do_sh;                                                       \
  a.causal = causal; a.causal_offset = causal_offset; a.c = c; a.scale = scale
#define FLASH_DKV_ARGS(a)                                                                         \
  Args a = {};                                                                                   \
  a.q = q; a.k = k; a.v = v; a.dout = dout;                                                      \
  a.lse = const_cast<float*>(static_cast<const float*>(lse));                                    \
  a.delta = const_cast<float*>(static_cast<const float*>(delta)); a.dk = dk; a.dv = dv;          \
  a.seg_q = static_cast<const int*>(seg_q); a.seg_kv = static_cast<const int*>(seg_kv);         \
  a.B = B; a.S = S; a.T = T; a.H = H; a.Hkv = Hkv; a.D = D;                                      \
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh; a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;      \
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh; a.do_sb = do_sb; a.do_ss = do_ss; a.do_sh = do_sh; \
  a.causal = causal; a.causal_offset = causal_offset; a.c = c; a.scale = scale
