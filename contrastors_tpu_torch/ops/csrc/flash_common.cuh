// Building blocks of the flash-attention kernels (flash_fwd.cu: the forward;
// flash_bwd.cu: dq and dk/dv). All three are persistent, warp-specialised
// kernels of one shape: a producer warpgroup that loads an item's fixed
// tiles into one of two slots and the walked 64-row tiles into a ring of
// mbarrier-guarded stages by TMA, and consumer warpgroups that run wgmma on
// them. Here: the masks, the rotary arithmetic and rule (and its adjoint),
// the row stores, the pipeline's configuration, shared memory and producer
// steps, the wgmma wrappers and descriptors, the kv walk, the rotation of
// swizzled tiles, and on the host the tensor maps and the launch.
//
// Accumulator layout of wgmma m64nNk16 (per warp of the warpgroup, g = lane
// / 4, t = lane % 4, the m16n8k16 layout of each 8-column block j):
//   d[j][0..1]: (row g, cols 8j + 2t, 8j + 2t + 1),
//   d[j][2..3]: (row g + 8, the same cols).
// Each thread thus holds two rows of its warp's 16: r0 = g and r1 = g + 8,
// and the four threads of a quad share those rows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace flash {

using namespace hopper;

constexpr float kNegInf = -1e30f;
constexpr int kWalk = 64;  // rows of a walked tile: one ring stage

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&x);
  return __bfloat1622float2(v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 2^x by the SFU's ex2.approx.ftz: one instruction (exp2f adds a range
// check and two multiplies to keep subnormal results); a result below
// 2^-126 flushes to 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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
// them to a multiple of kWalk rows, so every tile row has a table row. The
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

// sign s of rot(x)_c = s * x_partner
__device__ __forceinline__ float rot_sign(int c, const Rotary& r) {
  return (r.interleaved ? (c & 1) : (c >= r.half)) ? 1.f : -1.f;
}

// x * cos + (s * xp) * sin, each product and the sum rounded once
__device__ __forceinline__ float rot1(float x, float xp, float s, float cs, float sn) {
  return __fadd_rn(__fmul_rn(x, cs), __fmul_rn(s * xp, sn));
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

// ---- the pipeline ------------------------------------------------------------

// The shape of a kernel: kC consumer warpgroups of 64 output rows each,
// whether it rotates (kRot: a stage also holds its rows' cos and sin
// entries), and kFixed fixed operands per item (forward: q; dq: q, dO;
// dk/dv: k, v). kC = 1 where an item has at most 64 rows, so that two
// blocks of one warpgroup share an SM and each takes its own items; the
// backward also at D = 128, where dk and dv alone hold 128 fp32
// accumulators a thread.
template <int D, int kC, bool kRot, int kFixed = 2>
struct Cfg {
  static constexpr int kConsumers = kC;
  static constexpr int kRows = 64 * kC;                // output rows of an item
  static constexpr int kConsumerThreads = kC * 128;
  static constexpr int kBlocksPerSM = D == 64 && kC == 1 ? 2 : 1;
  // The producer is a warpgroup: its first warp loads, the other three
  // rotate the walked tiles (kRot). Where the block's threads would get
  // fewer than 255 registers each, it gives registers to the consumers: the
  // block is launched at 65536 / (threads x blocks per SM) registers a
  // thread, then the producer lowers to kProducerRegs and the consumers rise
  // to kConsumerRegs (dk and dv need more than the launch's 168 with two
  // consumers, or 128 with one). At D = 128 with one consumer (256 threads,
  // one block per SM) every thread may take 255.
  static constexpr bool kShiftRegs = D == 64 || kC >= 2;
  static constexpr int kThreads = kConsumerThreads + 128;
  static constexpr int kProducerRegs = 56;
  static constexpr int kConsumerRegs = kC == 3 ? 152 : kC == 2 ? 224 : 200;
  static_assert(!kShiftRegs || kBlocksPerSM * (128 * kProducerRegs + kConsumerThreads * kConsumerRegs) <= 65536,
                "the shifted registers of the blocks on an SM fit its register file");
  static constexpr int kRotators = kRot ? 96 : 0;       // threads that rotate the walked tiles
  static constexpr int kFullArrivals = 32 + kRotators;  // a stage is ready after these
  static constexpr int kFixedBytes = kRows * D * 2;    // one fixed operand
  static constexpr int kSlots = 2;                     // item slots: kFixed fixed operands each
  static constexpr int kSlotBytes = kFixed * kFixedBytes;
  static constexpr int kWalkBytes = kWalk * D * 2;     // one walked operand
  static constexpr int kStages = D == 64 ? (kC >= 2 ? 4 : 2) : (kRot ? 2 : 3);
  static constexpr int kStageBytes = 2 * kWalkBytes;
  static constexpr int kTableBytes = kRot ? 2 * kWalk * (D / 2) * 4 : 0;  // a stage's cos, sin entries
  static constexpr int kStageOffset = kSlots * kSlotBytes;
  static constexpr int kTableOffset = kStageOffset + kStages * kStageBytes;
  static constexpr int kExtraOffset = kTableOffset + kStages * kTableBytes;
  static constexpr int kExtraBytes = 3 * kWalk * 4 + 16;  // a stage's per-row values, its uniform segment id
  static constexpr int kBarOffset = kExtraOffset + kStages * kExtraBytes;
  static constexpr int kSmemBytes = 1024 + kBarOffset + (2 * kSlots + 3 * kStages) * 8;  // + alignment slack
  static_assert(kSmemBytes <= 232448, "a block's shared memory fits the SM's 227 KB");
};

// The shared memory of a block: the item slots, the ring's stages, the
// stages' table entries and per-row values, and the barriers, from a
// 1024-aligned base.
template <class C>
struct Pipe {
  uint8_t* base;   // generic address of the aligned base
  uint32_t sbase;  // its shared address

  __device__ uint32_t slot(int i) const { return sbase + i * C::kSlotBytes; }
  __device__ uint8_t* slot_ptr(int i) const { return base + i * C::kSlotBytes; }
  __device__ uint32_t stage(int s) const { return sbase + C::kStageOffset + s * C::kStageBytes; }
  __device__ uint8_t* stage_ptr(int s) const { return base + C::kStageOffset + s * C::kStageBytes; }
  __device__ float* table(int s) const {  // [2][kWalk][D / 2]: cos, then sin
    return reinterpret_cast<float*>(base + C::kTableOffset + s * C::kTableBytes);
  }
  template <class X>
  __device__ X* extra(int s, int i) const {  // the stage's i-th array of kWalk values
    return reinterpret_cast<X*>(base + C::kExtraOffset + s * C::kExtraBytes + i * kWalk * 4);
  }
  __device__ uint32_t bar(int i) const { return sbase + C::kBarOffset + 8 * i; }
  __device__ uint32_t slot_full(int i) const { return bar(i); }
  __device__ uint32_t slot_empty(int i) const { return bar(C::kSlots + i); }
  __device__ uint32_t full(int s) const { return bar(2 * C::kSlots + s); }
  __device__ uint32_t empty(int s) const { return bar(2 * C::kSlots + C::kStages + s); }
  __device__ uint32_t raw(int s) const { return bar(2 * C::kSlots + 2 * C::kStages + s); }  // kRot: loaded, unrotated
};

// Align the shared memory and let one thread set up the barriers: a slot's
// full barrier waits for the producer's one arrival and the slot's bytes; a
// stage's full barrier for the producer warp's 32 arrivals (after its
// lanes' writes) and the stage's bytes, or, with rotary, for those and the
// rotators' arrivals (after they rotated the stage), the bytes then going
// to the stage's raw barrier; every empty barrier for one arrival per
// consumer warp.
template <class C>
__device__ __forceinline__ Pipe<C> pipe_init(uint8_t* smem) {
  const uint32_t raw = smem_u32(smem);
  const uint32_t aligned = (raw + 1023u) & ~1023u;
  const Pipe<C> pp{smem + (aligned - raw), aligned};
  if (threadIdx.x == 0) {
    for (int i = 0; i < C::kSlots; ++i) {
      mbar_init(pp.slot_full(i), 1);
      mbar_init(pp.slot_empty(i), 4 * C::kConsumers);
    }
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(pp.full(s), C::kFullArrivals);
      mbar_init(pp.empty(s), 4 * C::kConsumers);
      mbar_init(pp.raw(s), 1);
    }
    fence_barrier_init();
  }
  __syncthreads();
  return pp;
}

// ---- wgmma ----------------------------------------------------------------

#define FB_ACC4(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])

// d[64 x 64] (+)= A[64 x 16] B[16 x 64]^T, A and B K-major in shared memory;
// d is zeroed first when scale_d == 0.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : FB_ACC4(0), FB_ACC4(1), FB_ACC4(2), FB_ACC4(3), FB_ACC4(4), FB_ACC4(5), FB_ACC4(6), FB_ACC4(7)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A in registers (bf16 pairs, the
// m16n8k16 A layout per warp), B MN-major in shared memory (transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : FB_ACC4(0), FB_ACC4(1), FB_ACC4(2), FB_ACC4(3), FB_ACC4(4), FB_ACC4(5), FB_ACC4(6), FB_ACC4(7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[64 x 128] += A[64 x 16] B[16 x 128], A in registers (bf16 pairs, the
// m16n8k16 A layout per warp), B MN-major in shared memory (transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : FB_ACC4(0), FB_ACC4(1), FB_ACC4(2), FB_ACC4(3), FB_ACC4(4), FB_ACC4(5), FB_ACC4(6), FB_ACC4(7), FB_ACC4(8), FB_ACC4(9), FB_ACC4(10), FB_ACC4(11), FB_ACC4(12), FB_ACC4(13), FB_ACC4(14), FB_ACC4(15)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef FB_ACC4

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 8][4], const uint32_t (&a)[4], uint64_t desc_b) {
  if constexpr (D == 64) wgmma_rs_n64(d, a, desc_b);
  else wgmma_rs_n128(d, a, desc_b);
}

// Keep the compiler from moving accumulator or A-fragment accesses across
// a wgmma fence or wait.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

__device__ __forceinline__ void fence_frag(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// K-major operand rows [64 wg, 64 wg + 64) of a tile of `rows` rows (D / 64
// boxes of rows x 128 B), its 16-deep step kk.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows, int wg, int kk) {
  return sw128_desc(tile + (kk / 4) * rows * 128 + wg * 64 * 128 + (kk % 4) * kKMajorStep, 8192, 1024);
}

// A 64-row walked tile as the MN-major B of a product contracting over its
// rows (N = D, boxes 8 KB apart), its 16-row step kk.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * kMNMajorStep, 8192, 1024);
}

// The C fragments of two adjacent 8-column blocks of a 64 x 64 accumulator
// are the A fragment of one 16-deep step, cast to bf16.
__device__ __forceinline__ void to_frag(uint32_t (&a)[4][4], const float (&x)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// ---- walks, rotation of swizzled tiles --------------------------------------

// The kv tiles a q tile [q_lo, q_hi] meets (dead tiles under causal or
// window masking contribute exactly 0): the first tile's start, and the
// number of 64-row steps.
__device__ __forceinline__ int kv_walk(int T, int causal, int causal_offset, int q_lo, int q_hi, int w2,
                                       int* begin) {
  int kv_begin = 0, kv_end = T;
  if (causal) kv_end = min(kv_end, q_hi + causal_offset + 1);
  if (w2 >= 0) {
    kv_begin = max(0, q_lo - w2);
    kv_end = min(kv_end, q_hi + w2 + 1);
  }
  kv_begin = kv_begin / kWalk * kWalk;
  *begin = kv_begin;
  return kv_end > kv_begin ? (kv_end - kv_begin + kWalk - 1) / kWalk : 0;
}

// The 16-byte chunk at (row r, column c, c a multiple of 8) of a swizzled
// tile of `rows` rows: D / 64 boxes of rows x 128 B, the chunks of row r
// permuted by r % 8.
__device__ __forceinline__ uint4* chunk_at(uint8_t* tile, int rows, int r, int c) {
  return reinterpret_cast<uint4*>(tile + (c / 64) * rows * 128 + r * 128 + ((((c % 64) >> 3) ^ (r & 7)) << 4));
}

// Rotate one 16-byte chunk (columns c..c+7) of row rr of a swizzled tile of
// `rows` rows in place, with the row's table entries cv / sv at those
// columns: a NeoX chunk together with its partner chunk rot_dim / 2 further
// on (which takes the same entries: the expanded tables duplicate them), a
// GPT-J chunk alone (four pairs). Products and the sum rounded apart, one
// cast: `rot1`, as the plain version rotates.
__device__ __forceinline__ void rotate_chunk_at(uint8_t* tile, int rows, int rr, int c, const float (&cv)[8],
                                                const float (&sv)[8], const Rotary& r) {
  uint4* px = chunk_at(tile, rows, rr, c);
  uint4 x = *px;
  uint32_t xs[4] = {x.x, x.y, x.z, x.w};
  if (r.interleaved) {  // pairs (c + 2i, c + 2i + 1): (-x1, x0)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = unpack_bf16(xs[i]);
      xs[i] = pack_bf16(rot1(v.x, v.y, -1.f, cv[2 * i], sv[2 * i]), rot1(v.y, v.x, 1.f, cv[2 * i + 1], sv[2 * i + 1]));
    }
  } else {  // columns c.. with their partners c + half..: (-x_p, x_c)
    uint4* pp = chunk_at(tile, rows, rr, c + r.half);
    const uint4 xp = *pp;
    uint32_t ps[4] = {xp.x, xp.y, xp.z, xp.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = unpack_bf16(xs[i]), w = unpack_bf16(ps[i]);
      xs[i] = pack_bf16(rot1(v.x, w.x, -1.f, cv[2 * i], sv[2 * i]), rot1(v.y, w.y, -1.f, cv[2 * i + 1], sv[2 * i + 1]));
      ps[i] = pack_bf16(rot1(w.x, v.x, 1.f, cv[2 * i], sv[2 * i]), rot1(w.y, v.y, 1.f, cv[2 * i + 1], sv[2 * i + 1]));
    }
    *pp = make_uint4(ps[0], ps[1], ps[2], ps[3]);
  }
  *px = make_uint4(xs[0], xs[1], xs[2], xs[3]);
}

// Chunks to rotate per row: NeoX chunks below rot_dim / 2 (each with its
// partner), GPT-J chunks below rot_dim.
__device__ __forceinline__ int rot_chunks(const Rotary& r) { return r.interleaved ? r.half / 4 : r.half / 8; }

// Rotate rows [r_lo, r_hi) of a swizzled tile of `rows` rows in place, with
// the expanded tables in device memory (the fixed operand, once per item);
// tile row r is sequence position row0 + r; positions at or past n_rows
// are left as they are (zeros). The nthreads threads from tid split the
// chunks.
template <int D>
__device__ __forceinline__ void rotate_rows(uint8_t* tile, int rows, int row0, int n_rows, const float* tcos,
                                            const float* tsin, const Rotary& r, int tid, int nthreads, int r_lo,
                                            int r_hi) {
  const int per_row = rot_chunks(r);
  for (int u = tid; u < (r_hi - r_lo) * per_row; u += nthreads) {
    const int rr = r_lo + u / per_row, c = (u % per_row) * 8, pos = row0 + rr;
    if (pos >= n_rows) continue;
    const float4* cs = reinterpret_cast<const float4*>(tcos + int64_t(pos) * D + c);
    const float4* sn = reinterpret_cast<const float4*>(tsin + int64_t(pos) * D + c);
    const float4 c0 = cs[0], c1 = cs[1], s0 = sn[0], s1 = sn[1];
    const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    rotate_chunk_at(tile, rows, rr, c, cv, sv, r);
  }
}

// Rotate a NeoX walked tile (kWalk rows from sequence position row0) in
// place, with the entries TMA staged beside it: tab = cos [kWalk][half],
// sin at tab + kWalk * D / 2, one entry per rotated pair (columns i and
// i + half).
template <int D>
__device__ __forceinline__ void rotate_walked(uint8_t* tile, const float* tab, int row0, int n_rows, const Rotary& r,
                                              int tid, int nthreads) {
  const int per_row = rot_chunks(r), half = r.half;
  const float* tsin = tab + kWalk * (D / 2);
  for (int u = tid; u < kWalk * per_row; u += nthreads) {
    const int rr = u / per_row, c = (u % per_row) * 8;
    if (row0 + rr >= n_rows) continue;
    const float4* cs = reinterpret_cast<const float4*>(tab + rr * half + c);
    const float4* sn = reinterpret_cast<const float4*>(tsin + rr * half + c);
    const float4 c0 = cs[0], c1 = cs[1], s0 = sn[0], s1 = sn[1];
    const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    rotate_chunk_at(tile, kWalk, rr, c, cv, sv, r);
  }
}

// Rotate a walked tile: NeoX from the staged entries, GPT-J (whose pairs'
// entries are every other table column) from the tables in device memory.
template <int D>
__device__ __forceinline__ void rotate_stage(uint8_t* tile, const float* tab, int row0, int n_rows, const float* tcos,
                                             const float* tsin, const Rotary& r, int tid, int nthreads) {
  if (r.interleaved)
    rotate_rows<D>(tile, kWalk, row0, n_rows, tcos, tsin, r, tid, nthreads, 0, kWalk);
  else
    rotate_walked<D>(tile, tab, row0, n_rows, r, tid, nthreads);
}

// ---- the producer's steps ----------------------------------------------------

// The 4-D tensor maps (dims D, heads, rows, batch; box 64 x 1 x rows x 1)
// of a kernel's operands: fixed0/fixed1 are loaded per item (box rows
// kRows), walked0/walked1 per stage (box rows kWalk); with rotary, the 3-D
// maps of the expanded fp32 NeoX tables (dims D, rows, table batch), whose
// box takes one entry per rotated pair of kWalk rows: columns 0..half-1.
struct Maps {
  CUtensorMap fixed0, fixed1, walked0, walked1, cos, sin;
};

// Load one operand's tile (D / 64 boxes of `rows` rows) at (head, row0, b).
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar, int rows, int head,
                                          int row0, int b) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c) tma_load_4d(dst + c * rows * 128, map, bar, 64 * c, head, row0, b);
}

// The producer's item start (one lane): wait for the slot to be free, then
// load the item's fixed operands into it.
template <int D, class C>
__device__ __forceinline__ void produce_item(const Pipe<C>& pp, const Maps& m, int n, int head, int row0, int b) {
  const int i = n % C::kSlots;
  mbar_wait(pp.slot_empty(i), ((n / C::kSlots) & 1) ^ 1);
  const uint32_t bar = pp.slot_full(i);
  mbar_expect_tx(bar, C::kSlotBytes);
  load_tile<D>(pp.slot(i), &m.fixed0, bar, C::kRows, head, row0, b);
  if (C::kSlotBytes > C::kFixedBytes) load_tile<D>(pp.slot(i) + C::kFixedBytes, &m.fixed1, bar, C::kRows, head, row0, b);
}

// The producer's step, all lanes: wait for the stage to be free.
template <class C>
__device__ __forceinline__ int produce_wait(const Pipe<C>& pp, int step) {
  const int s = step % C::kStages;
  mbar_wait(pp.empty(s), ((step / C::kStages) & 1) ^ 1);
  return s;
}

// Then, after the lanes' writes of the stage's per-row values: lane 0 loads
// the two walked tiles at (head, row0, b) and, with NeoX rotary (half > 0),
// their rows' table entries (table batch tb); every lane arrives. seg is this lane's
// two segment ids of the tile (rows lane and lane + 32; 0 past the
// sequence): lane 0 records the id the whole tile shares (0: every row is
// masked), or -1.
template <int D, bool kRot, class C>
__device__ __forceinline__ void produce_stage(const Pipe<C>& pp, const Maps& m, int s, int lane, int head, int row0,
                                              int b, int seg0, int seg1, int half, int tb) {
  const int first = __shfl_sync(0xffffffffu, seg0, 0);  // every lane, outside any condition
  const bool same = __all_sync(0xffffffffu, seg0 == first && seg1 == first);
  const uint32_t bar = kRot ? pp.raw(s) : pp.full(s);  // where the bytes land
  if (lane == 0) {
    *pp.template extra<int>(s, 3) = same ? seg0 : -1;
    mbar_expect_tx(bar, C::kStageBytes + 2 * kWalk * half * 4);
    load_tile<D>(pp.stage(s), &m.walked0, bar, kWalk, head, row0, b);
    load_tile<D>(pp.stage(s) + C::kWalkBytes, &m.walked1, bar, kWalk, head, row0, b);
    if (kRot && half > 0) {
      const uint32_t tab = smem_u32(pp.table(s));
      tma_load_3d(tab, &m.cos, bar, 0, row0, tb);
      tma_load_3d(tab + kWalk * (D / 2) * 4, &m.sin, bar, 0, row0, tb);
    }
  }
  if (kRot || lane != 0) mbar_arrive(pp.full(s));
}

// The kv-walking producer's step (forward, dq): the kv tile's segment ids
// (unmasked: one segment; a partial tile is masked), read before waiting
// for the stage so that the wait hides their latency, written beside the
// stage, then the stage's loads.
template <int D, bool kRot, class C>
__device__ __forceinline__ void produce_kv_stage(const Pipe<C>& pp, const Maps& m, int step, int lane, int hk,
                                                 int kv0, int b, int T, const int* seg_kv, int half, int tb) {
  int seg0 = kv0 + lane < T, seg1 = kv0 + lane + 32 < T;
  if (seg_kv != nullptr) {
    seg0 = seg0 ? __ldg(seg_kv + b * T + kv0 + lane) : 0;
    seg1 = seg1 ? __ldg(seg_kv + b * T + kv0 + lane + 32) : 0;
  }
  const int s = produce_wait(pp, step);
  int* seg = pp.template extra<int>(s, 0);
  seg[lane] = seg0;
  seg[lane + 32] = seg1;
  produce_stage<D, kRot>(pp, m, s, lane, hk, kv0, b, seg0, seg1, half, tb);
}

// The rotators' step: wait for stage s's bytes, rotate its first walked
// tile (kWalk rows from sequence position row0), make the writes visible to
// wgmma, arrive on its full barrier.
template <int D, class C>
__device__ __forceinline__ void rotate_step(const Pipe<C>& pp, int step, int row0, int n_rows, const float* tcos,
                                            const float* tsin, const Rotary& r, int tid) {
  const int s = step % C::kStages;
  mbar_wait(pp.raw(s), (step / C::kStages) & 1);
  rotate_stage<D>(pp.stage_ptr(s), pp.table(s), row0, n_rows, tcos, tsin, r, tid, C::kRotators);
  fence_proxy_async();
  mbar_arrive(pp.full(s));
}

// ---- host side ----------------------------------------------------------------

// The tensor map of a [B, n_rows, heads, D] bf16 operand with strides (batch,
// row, head) in elements, for tiles of box_rows rows of one head.
inline bool operand_map(CUtensorMap* map, const void* ptr, int D, int heads, int n_rows, int B, int64_t sb,
                        int64_t ss, int64_t sh, int box_rows) {
  const int64_t dims[4] = {D, heads, n_rows, B}, strides[3] = {sh, ss, sb};
  const int box[4] = {64, 1, box_rows, 1};
  return make_map(map, ptr, 4, dims, strides, box);
}

// The map of an expanded fp32 NeoX rotary table ([rows, D], or [B, rows, D]
// with batch stride sb elements; rows = S rounded up to kWalk, as the
// wrapper pads them), no swizzle, whose box is the first `half` columns
// (one entry per rotated pair) of kWalk rows.
inline bool table_map(CUtensorMap* map, const void* table, int D, int S, int B, int64_t sb, int half) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const int rows = (S + kWalk - 1) / kWalk * kWalk;
  const cuuint64_t dims[3] = {cuuint64_t(D), cuuint64_t(rows), cuuint64_t(sb ? B : 1)};
  const cuuint64_t strides[2] = {cuuint64_t(D) * 4, cuuint64_t(sb ? sb : int64_t(rows) * D) * 4};
  const cuuint32_t box[3] = {cuuint32_t(half), cuuint32_t(kWalk), 1}, unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(table), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The rotary tables' maps, when the fused variant runs with NeoX pairs.
inline bool rotary_maps(Maps* maps, const Rotary& rot, int D, int S, int B) {
  return rot.cos == nullptr || rot.interleaved ||
         (table_map(&maps->cos, rot.cos, D, S, B, rot.sb, rot.half) &&
          table_map(&maps->sin, rot.sin, D, S, B, rot.sb, rot.half));
}

// Cfg::kSmemBytes of dynamic shared memory (above the 48 KB default:
// allowed once per kernel); a persistent grid of kBlocksPerSM blocks per SM,
// at most one per item.
template <class C, class P>
cudaError_t launch(void (*kernel)(Maps, P), bool* ready, const Maps& maps, const P& p, int items, cudaStream_t st) {
  cudaError_t err = cudaSuccess;
  if (!*ready) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
    if (err != cudaSuccess) return err;
    *ready = true;
  }
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  kernel<<<min(items, sms * C::kBlocksPerSM), C::kThreads, C::kSmemBytes, st>>>(maps, p);
  return cudaGetLastError();
}

}  // namespace flash
