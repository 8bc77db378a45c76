// Building blocks of the flash-attention kernels. flash_fwd.cu: bf16
// mma.sync m16n8k16 with fp32 accumulation on 64-row tiles, four warps of
// 16 rows each, and the fused-rotary loads of its q fragments and k tiles.
// flash_bwd.cu (wgmma, whose accumulator holds the same per-warp layout):
// the masks, the rotary arithmetic and rule, the adjoint and the row stores.
//
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4):
//   A regs 0..3: (row g, cols 2t..2t+1), (row g+8, 2t..), (row g, 2t+8..),
//                (row g+8, 2t+8..)
//   B regs 0..1: (k 2t..2t+1, col g), (k 2t+8..2t+9, col g)
//   C floats 0..3: (row g, cols 2t, 2t+1), (row g+8, cols 2t, 2t+1)
// Each thread thus holds two rows of its warp's 16: r0 = g and r1 = g + 8,
// and the four threads of a quad share those rows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kTile = 64;  // rows of every q and kv tile: 4 warps x 16 rows
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a * b for one m16n8k16 tile: a 16x16 row-major bf16, b 16x8 col-major
// bf16, d 16x8 fp32.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Is (query row q, key col kv) inside the causal / window band? w2 < 0
// means no window.
__device__ __forceinline__ bool in_band(int q, int kv, int causal, int causal_offset, int w2) {
  return (!causal || q + causal_offset >= kv) && (w2 < 0 || abs(q - kv) <= w2);
}

// ---------------------------------------------------------------------------
// Fused rotary (JAX flash_attention.py:_rot_block, _rot_adjoint). The tables
// are fp32 rows of D columns, one per sequence position, laid out per
// convention (duplicated halves for NeoX, repeated pairs for GPT-J) with
// identity rows (cos 1, sin 0) over a pass-through tail; the wrapper pads
// them to a multiple of kTile rows, so every tile row has a table row. The
// rotate-half permutation pairs column c with partner p: NeoX p = c +- half,
// interleaved p = c ^ 1; rot(x)_c = -x_p for c < half (c even when
// interleaved) and +x_p otherwise. It is computed by index: the JAX kernels'
// signed one-hot matmul x @ R gives the same values. Products and the sum
// are rounded apart (no FMA contraction), then cast once to bf16, which are
// the rounding points of JAX's _rot_block and of the port's plain version.
// half is a multiple of 8, so a 16-byte chunk and its partner chunk are
// both whole, and the partner of an accumulator column is held by the same
// thread.

struct Rotary {
  const float* cos;  // [L, D] (sb == 0, shared by the batch) or [B, L, D]
  const float* sin;
  int64_t sb;        // batch stride of the tables, in elements
  int half;          // rot_dim / 2
  int interleaved;   // GPT-J pairs (1) or NeoX halves (0)
};

// The rotary arguments of a call are sound: no tables (the plain variant),
// or rot_dim / 2 a positive multiple of 8 with rot_dim <= D.
inline bool rot_ok(const void* rot_cos, int rot_half, int D) {
  return rot_cos == nullptr || (rot_half > 0 && rot_half % 8 == 0 && 2 * rot_half <= D);
}

__device__ __forceinline__ int rot_partner(int c, const Rotary& r) {
  return r.interleaved ? (c ^ 1) : (c < r.half ? c + r.half : c - r.half);
}

// sign s of rot(x)_c = s * x_partner
__device__ __forceinline__ float rot_sign(int c, const Rotary& r) {
  return (r.interleaved ? (c & 1) : (c >= r.half)) ? 1.f : -1.f;
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&x);
  return __bfloat1622float2(v);
}

// x * cos + (s * xp) * sin, each product and the sum rounded once
__device__ __forceinline__ float rot1(float x, float xp, float s, float cs, float sn) {
  return __fadd_rn(__fmul_rn(x, cs), __fmul_rn(s * xp, sn));
}

// Rotate the bf16 pair at columns (c, c + 1), c even, of one row. xp holds
// the pair at the partner columns (NeoX; unused when interleaved, where the
// partner is the other half of x); cs / sn are the row's table rows.
__device__ __forceinline__ uint32_t rotate_pair(uint32_t x, uint32_t xp, const float* cs,
                                                const float* sn, int c, const Rotary& r) {
  if (c >= 2 * r.half) return x;
  const float2 v = unpack_bf16(x);
  const float2 w = r.interleaved ? make_float2(v.y, v.x) : unpack_bf16(xp);
  const float2 cv = *reinterpret_cast<const float2*>(cs + c);
  const float2 sv = *reinterpret_cast<const float2*>(sn + c);
  return pack_bf16(rot1(v.x, w.x, rot_sign(c, r), cv.x, sv.x),
                   rot1(v.y, w.y, rot_sign(c + 1, r), cv.y, sv.y));
}

// Rotate a row's 16-byte chunk of columns c0..c0+7 (c0 a multiple of 8),
// read from `row` (a row of a bf16 matrix in device memory, unit stride).
__device__ __forceinline__ uint4 rotate_chunk(uint4 x, const __nv_bfloat16* row, const float* cs,
                                              const float* sn, int c0, const Rotary& r) {
  if (c0 >= 2 * r.half) return x;
  uint4 xp = x;
  if (!r.interleaved) xp = *reinterpret_cast<const uint4*>(row + rot_partner(c0, r));
  x.x = rotate_pair(x.x, xp.x, cs, sn, c0, r);
  x.y = rotate_pair(x.y, xp.y, cs, sn, c0 + 2, r);
  x.z = rotate_pair(x.z, xp.z, cs, sn, c0 + 4, r);
  x.w = rotate_pair(x.w, xp.w, cs, sn, c0 + 6, r);
  return x;
}

// Rotate A fragments (load_a_global's layout) of rows r0, r0 + 8 in place;
// base is the matrix in device memory, for the NeoX partner pairs.
template <int D>
__device__ __forceinline__ void rotate_a(uint32_t (&a)[D / 16][4], const __nv_bfloat16* base,
                                         int64_t row_stride, int r0, int n_rows, int t,
                                         const float* tcos, const float* tsin, const Rotary& r) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = r0 + (j & 1) * 8;
      const int c = kc * 16 + t * 2 + (j >> 1) * 8;
      uint32_t xp = 0u;
      if (!r.interleaved && row < n_rows && c < 2 * r.half) xp = ld32(base + row * row_stride + rot_partner(c, r));
      a[kc][j] = rotate_pair(a[kc][j], xp, tcos + row * D, tsin + row * D, c, r);
    }
  }
}

// The value at column block i of accumulator y (C layout, element e), for a
// block index known only at run time, without local-memory indexing.
template <int N>
__device__ __forceinline__ float pick(const float (&y)[N][4], int i, int e) {
  float v = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j == i) v = y[j][e];
  return v;
}

// g -> g * cos + rot^T(g * sin) on an fp32 C-fragment accumulator of rows
// r0 (elements 0, 1) and r0 + 8 (elements 2, 3), in place: the adjoint of
// the rotation (rot^T = -rot), applied before the single bf16 cast. Rows
// at or past n_rows (never stored) read the last row's tables.
template <int D>
__device__ __forceinline__ void rotate_adjoint(float (&g)[D / 8][4], const float* tcos,
                                               const float* tsin, int r0, int t, const Rotary& r,
                                               int n_rows) {
  constexpr int kDn = D / 8;
  float y[kDn][4];
#pragma unroll
  for (int dn = 0; dn < kDn; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = min(r0 + (e >> 1) * 8, n_rows - 1), c = dn * 8 + t * 2 + (e & 1);
      y[dn][e] = __fmul_rn(g[dn][e], tsin[row * D + c]);
    }
#pragma unroll
  for (int dn = 0; dn < kDn; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = min(r0 + (e >> 1) * 8, n_rows - 1), c = dn * 8 + t * 2 + (e & 1);
      if (c >= 2 * r.half) continue;
      // the partner column is in this thread: the other element of the
      // pair (interleaved) or column block dn +- half / 8 (NeoX)
      const float yp = r.interleaved ? y[dn][e ^ 1]
                                     : pick(y, c < r.half ? dn + r.half / 8 : dn - r.half / 8, e);
      g[dn][e] = __fadd_rn(__fmul_rn(g[dn][e], tcos[row * D + c]), -rot_sign(c, r) * yp);
    }
}

// Write this thread's part of rows r0 and r0 + 8 of a 16 x D fp32
// accumulator as bf16 into a contiguous [rows, heads, D] matrix.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, int64_t row_stride,
                                           const float (&acc)[D / 8][4], int r0, int n_rows,
                                           int t) {
  if (r0 < n_rows) {
    __nv_bfloat16* row = base + r0 * row_stride + t * 2;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(row + dn * 8) = pack_bf16(acc[dn][0], acc[dn][1]);
  }
  if (r0 + 8 < n_rows) {
    __nv_bfloat16* row = base + (r0 + 8) * row_stride + t * 2;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(row + dn * 8) = pack_bf16(acc[dn][2], acc[dn][3]);
  }
}

}  // namespace flash
