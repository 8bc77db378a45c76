// Flash-attention backward for Hopper (sm_90a): bf16 q/k/v/O/dO/dq/dk/dv,
// fp32 LSE and delta.
//
// Replaces the two Pallas TPU backward kernels of
// contrastors_tpu/ops/flash_attention.py, both launched by _bwd (:608):
//   _bwd_dq_kernel  (:422, call :640) -> flash_bwd_dq_kernel<D, false>,
//   _bwd_dkv_kernel (:512, call :700) -> flash_bwd_dkv_kernel<D, false>,
// and their fused_rot=True forms (:426-446, :516-545; adjoint :502-509,
// :600-604) -> the same kernels with kRot = true.
// On the TPU each kernel carries its accumulator in VMEM scratch across the
// sequential innermost grid axis. Here a block owns an output tile (an
// "item") and walks that axis as a loop, with the accumulator in fp32
// registers:
//   dq:  an item is a tile of q rows of one (batch, head); the walk runs
//        over 64-row kv tiles;
//   dkv: an item is a tile of kv rows of one (batch, kv head); the walk runs
//        over the GQA group's q heads x 64-row q tiles.
// Every output tile has one owner and sums in a fixed order: no atomics, and
// two runs on the same inputs are bit-identical. p is recomputed from the
// forward's base-2 LSE, so the dq kernel runs three products (s = q k^T,
// dp = dO v^T, dq += ds k) and the dkv kernel four (s^T, dp^T, dv += p^T dO,
// dk += ds^T q).
//
// What bounds them on an H100: each product is 2*D FLOP per live (row, col)
// pair, against q, k, v, O, dO read once and dq (dk, dv) written once: 3*S/4
// (dq) or S (dkv) FLOP per byte at S = T, D = 64. Bytes bound the short
// training shapes (S = 32, 256), the tensor cores the MLM shape (S = 2048).
// Only wgmma reaches the tensor cores' full rate, and only when its
// operands are in shared memory ahead of it. The design:
//   - Warp-specialised blocks: a producer warpgroup (one warp loads; with
//     rotary the other three rotate) and kC consumer warpgroups, each
//     consumer owning 64 rows of the item. kC = 2 (128-row items, one block
//     per SM) at D = 64; kC = 1 at D = 128, where dk and dv alone hold 128
//     fp32 accumulators a thread, and at D = 64 where the item's rows (S for
//     dq, T for dk/dv) are at most 64: then two one-warpgroup blocks share
//     an SM and each streams its own items. At D = 64 `setmaxnreg` moves
//     registers from the producer (56 a thread) to the consumers (224 with
//     two, 200 with one), above the launch's 168 / 128: dk/dv needs them,
//     and spilled at 168. The item's fixed operands (dq: q and
//     dO; dkv: k and v) are one TMA load into one of two item slots; the
//     walked operands (dq: k and v; dkv: q and dO) go through a ring of
//     64-row stages, each filled by TMA (cp.async.bulk.tensor, 128-byte
//     swizzle, 4-D tensor maps over the [B, S, H, D] storage and its
//     strides, a row of D = 128 being two 64-wide boxes) behind a full and
//     an empty mbarrier; with NeoX rotary, the rows' table entries come in
//     the same stage by TMA. The producer's lanes read the stage's per-row
//     values (dq: the kv tile's segment ids; dkv: the q tile's -LSE, delta
//     and segment ids) before waiting for the stage, write them and the
//     segment id the whole tile shares (or -1), and arrive on its full
//     barrier. Every consumer warp releases the stage when done with it.
//   - Products: s and dp by wgmma m64n64k16 from shared memory, both
//     operands K-major; p and ds in fp32 registers, cast to bf16 in the
//     registers as wgmma's A operand (the accumulator layout of one 16-deep
//     step is the A layout), so dq += ds k, dv += p^T dO and dk += ds^T q
//     read only their B operand from shared memory, MN-major through the
//     transpose bit: no copies.
//   - Persistent: the grid is as many blocks as fit on the SMs, each walking
//     items (row tiles of each (batch, head), adjacent tiles of one head
//     together), so the producer loads the next item's tiles while this one
//     computes; at S = T = 32 264 blocks stream ~23 items each instead of
//     6144 blocks running once. A consumer whose rows lie past S (T)
//     computes on zero rows.
//   - Delta = rowsum(dO * O) is computed by the dq kernel from O and dO, per
//     row, and written to a [B, H, S] fp32 buffer that the dkv kernel,
//     launched after it on the same stream, reads. Every row gets its delta,
//     also where no kv tile is live.
//   - Dead tiles under causal or window masking are skipped, as the JAX
//     kernels skip them. A warp whose rows all share the tile's one segment
//     (an unmasked or all-ones mask, a whole tile), with no band, takes a
//     branch-free softmax; the others check every (row, col) pair.
// Dynamic shared memory per block (Cfg::kSmemBytes): 132 KiB (plain) / 196
// KiB (rotary) with two warpgroups, 67 / 99 KiB with one at D = 64; 163 /
// 195 KiB at D = 128.
//
// Fused rotary (kRot; the tables are fp32 rows of D columns, duplicated
// halves for NeoX, repeated pairs for GPT-J, identity rows past rot_dim and
// past S): the fixed operand (dq: q, dkv: k) is rotated once per item from
// the tables in device memory, by the consumers, before a proxy fence and a
// barrier (wgmma reads shared memory through the async proxy); the walked
// one (dq: k, dkv: q) once per stage, off the consumers' path, by the
// producer warpgroup's three other warps: they wait for the stage's bytes
// (its raw barrier), rotate it in shared memory, NeoX from the entries TMA
// staged beside it (one per rotated pair: a quarter of the table bytes that
// rotating each element from both tables reads), GPT-J from the tables in
// device memory, fence, and arrive on its full barrier.
// Products and the sum are rounded apart, then cast once: bit-identical to
// the plain version's rotated bf16 operand. dq (dk) is accumulated with
// respect to the rotated operand in fp32, and the rotation's adjoint
// g*cos + rot^T(g*sin) is applied to the fp32 accumulator before the single
// bf16 cast (the partner column of every accumulator element lives in the
// same thread).
//
// Semantics follow JAX _bwd: s = q.k^T * c (c = softmax_scale*log2(e)) with
// the forward's masks; p = exp2(s - lse), and p = 0 on rows whose LSE is
// -1e30 (fully masked rows have O = 0 and dq = 0); dp = dO.v^T;
// ds = p * (dp - delta) * softmax_scale; dq = bf16(ds) k, dk = bf16(ds)^T q,
// dv = bf16(p)^T dO (JAX keeps p in fp32 for dv; rounding it to bf16 makes it
// a tensor-core operand, as on the TPU's MXU at default precision).

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace flash;
using namespace hopper;

constexpr int kWalk = 64;  // rows of a walked tile: one ring stage

// The shape of a kernel: kC consumer warpgroups of 64 output rows each (two
// at D = 64, one at D = 128, where dk and dv alone hold 128 fp32
// accumulators a thread; also one at D = 64 where an item has at most 64
// rows, so that two blocks of one warpgroup share an SM and each takes its
// own items), and whether it rotates (kRot: a stage also holds its rows'
// cos and sin entries).
template <int D, int kC, bool kRot>
struct Cfg {
  static constexpr int kConsumers = kC;
  static constexpr int kRows = 64 * kC;                // output rows of an item
  static constexpr int kConsumerThreads = kC * 128;
  static constexpr int kBlocksPerSM = D == 64 && kC == 1 ? 2 : 1;
  // The producer is a warpgroup: its first warp loads, the other three
  // rotate the walked tiles (kRot). At D = 64 it gives registers to the
  // consumers: the block is launched at 65536 / (threads x blocks per SM)
  // registers a thread, then the producer lowers to kProducerRegs and the
  // consumers rise to kConsumerRegs (dk and dv need more than the launch's
  // 168 with two consumers, or 128 with one). At D = 128 (256 threads, one
  // block per SM) every thread may take 255.
  static constexpr bool kShiftRegs = D == 64;
  static constexpr int kThreads = kConsumerThreads + 128;
  static constexpr int kProducerRegs = 56;
  static constexpr int kConsumerRegs = kC == 2 ? 224 : 200;
  static_assert(!kShiftRegs || kBlocksPerSM * (128 * kProducerRegs + kConsumerThreads * kConsumerRegs) <= 65536,
                "the shifted registers of the blocks on an SM fit its register file");
  static constexpr int kRotators = kRot ? 96 : 0;       // threads that rotate the walked tiles
  static constexpr int kFullArrivals = 32 + kRotators;  // a stage is ready after these
  static constexpr int kFixedBytes = kRows * D * 2;    // one fixed operand
  static constexpr int kSlots = 2;                     // item slots: two fixed operands each
  static constexpr int kSlotBytes = 2 * kFixedBytes;
  static constexpr int kWalkBytes = kWalk * D * 2;     // one walked operand
  static constexpr int kStages = D == 64 ? (kC == 2 ? 4 : 2) : (kRot ? 2 : 3);
  static constexpr int kStageBytes = 2 * kWalkBytes;
  static constexpr int kTableBytes = kRot ? 2 * kWalk * (D / 2) * 4 : 0;  // a stage's cos, sin entries
  static constexpr int kStageOffset = kSlots * kSlotBytes;
  static constexpr int kTableOffset = kStageOffset + kStages * kStageBytes;
  static constexpr int kExtraOffset = kTableOffset + kStages * kTableBytes;
  static constexpr int kExtraBytes = 3 * kWalk * 4 + 16;  // a stage's per-row values, its uniform segment id
  static constexpr int kBarOffset = kExtraOffset + kStages * kExtraBytes;
  static constexpr int kSmemBytes = 1024 + kBarOffset + (2 * kSlots + 3 * kStages) * 8;  // + alignment slack
};

struct BwdParams {
  const __nv_bfloat16* o;     // [B, S, H, D] strided (dq: delta's O)
  const __nv_bfloat16* dout;  // [B, S, H, D] strided
  const float* lse;           // [B, H, S] base 2
  float* delta;               // [B, H, S]: written by dq, read by dkv
  __nv_bfloat16* dq;          // [B, S, H, D] contiguous
  __nv_bfloat16* dk;          // [B, T, Hkv, D] contiguous
  __nv_bfloat16* dv;          // [B, T, Hkv, D] contiguous
  const int* seg_q;           // [B, S] or null (unmasked)
  const int* seg_kv;          // [B, T] or null
  int B, S, T, H, Hkv;
  int64_t o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  int causal, causal_offset, window;
  float c;         // softmax_scale * log2(e)
  float sm_scale;  // softmax_scale
  Rotary rot;      // fused-rotary tables (kRot only)
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

// ---- per-row values, walks, rotation ---------------------------------------

// -lse for p = exp2(s*c - lse), or -inf on a dead row (LSE -1e30) and past
// n_rows: p is then exactly 0.
__device__ __forceinline__ float neg_lse(float lse) {
  return lse <= 0.5f * kNegInf ? -INFINITY : -lse;
}

// This thread's part of rowsum(a * b) for one row: D / 4 columns from
// tq * D / 4; the quad's four parts sum to the row's.
template <int D>
__device__ __forceinline__ float row_dot(const __nv_bfloat16* a, int64_t sa, const __nv_bfloat16* b, int64_t sb,
                                         int row, int n_rows, int tq) {
  constexpr int kCols = D / 4;
  float sum = 0.f;
  if (row < n_rows) {
    const __nv_bfloat16* pa = a + row * sa + tq * kCols;
    const __nv_bfloat16* pb = b + row * sb + tq * kCols;
#pragma unroll
    for (int i = 0; i < kCols; i += 8) {
      const uint4 x = *reinterpret_cast<const uint4*>(pa + i), y = *reinterpret_cast<const uint4*>(pb + i);
      const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 u = unpack_bf16(xs[j]), w = unpack_bf16(ys[j]);
        sum = fmaf(u.x, w.x, sum);
        sum = fmaf(u.y, w.y, sum);
      }
    }
  }
  return sum;
}

// The kv tiles a q tile [q_lo, q_hi] meets (dead tiles contribute exactly
// 0): the first tile's start, and the number of 64-row steps.
__device__ __forceinline__ int kv_walk(const BwdParams& p, int q_lo, int q_hi, int w2, int* begin) {
  int kv_begin = 0, kv_end = p.T;
  if (p.causal) kv_end = min(kv_end, q_hi + p.causal_offset + 1);
  if (w2 >= 0) {
    kv_begin = max(0, q_lo - w2);
    kv_end = min(kv_end, q_hi + w2 + 1);
  }
  kv_begin = kv_begin / kWalk * kWalk;
  *begin = kv_begin;
  return kv_end > kv_begin ? (kv_end - kv_begin + kWalk - 1) / kWalk : 0;
}

// The q tiles (per q head) a kv tile [kv_lo, kv_hi] meets.
__device__ __forceinline__ int q_walk(const BwdParams& p, int kv_lo, int kv_hi, int w2, int* begin) {
  int q_begin = 0, q_end = p.S;
  if (p.causal) q_begin = max(0, kv_lo - p.causal_offset);
  if (w2 >= 0) {
    q_begin = max(q_begin, kv_lo - w2);
    q_end = min(q_end, kv_hi + w2 + 1);
  }
  q_begin = q_begin / kWalk * kWalk;
  *begin = q_begin;
  return q_end > q_begin ? (q_end - q_begin + kWalk - 1) / kWalk : 0;
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
// cast: `rot1`, as the forward and the plain version rotate.
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

// ---- the kernels -------------------------------------------------------------

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
// load the item's two fixed operands into it.
template <int D, class C>
__device__ __forceinline__ void produce_item(const Pipe<C>& pp, const Maps& m, int n, int head, int row0, int b) {
  const int i = n % C::kSlots;
  mbar_wait(pp.slot_empty(i), ((n / C::kSlots) & 1) ^ 1);
  const uint32_t bar = pp.slot_full(i);
  mbar_expect_tx(bar, C::kSlotBytes);
  load_tile<D>(pp.slot(i), &m.fixed0, bar, C::kRows, head, row0, b);
  load_tile<D>(pp.slot(i) + C::kFixedBytes, &m.fixed1, bar, C::kRows, head, row0, b);
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
// sequence): lane 0 records the id the whole tile shares, or -1.
template <int D, bool kRot, class C>
__device__ __forceinline__ void produce_stage(const Pipe<C>& pp, const Maps& m, int s, int lane, int head, int row0,
                                              int b, int seg0, int seg1, int half, int tb) {
  const int first = __shfl_sync(0xffffffffu, seg0, 0);  // every lane, outside any condition
  const bool same = __all_sync(0xffffffffu, seg0 == first && seg1 == first);
  const uint32_t bar = kRot ? pp.raw(s) : pp.full(s);  // where the bytes land
  if (lane == 0) {
    *pp.template extra<int>(s, 3) = same && seg0 != 0 ? seg0 : -1;
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

// dq for items (b, h, tile of kRows q rows), and delta of their rows.
// fixed: q, dO; walked: k, v, with the kv tile's segment ids.
template <int D, int kC, bool kRot>
__global__ void __launch_bounds__(Cfg<D, kC, kRot>::kThreads, Cfg<D, kC, kRot>::kBlocksPerSM)
    flash_bwd_dq_kernel(const __grid_constant__ Maps maps, const BwdParams p) {
  using C = Cfg<D, kC, kRot>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const Pipe<C> pp = pipe_init<C>(smem);
  const int n_tiles = (p.S + C::kRows - 1) / C::kRows, items = p.B * p.H * n_tiles;
  const int group = p.H / p.Hkv, w2 = p.window > 0 ? p.window / 2 : -1;
  const bool has_seg = p.seg_q != nullptr;

  if (threadIdx.x >= C::kConsumerThreads) {  // the producer warpgroup: a loading warp, three rotators
    if constexpr (C::kShiftRegs) setmaxnreg_dec<C::kProducerRegs>();
    const int ptid = threadIdx.x - C::kConsumerThreads;
    if (ptid >= 32) {
      if constexpr (kRot) {  // the kv tiles' k rows, once per stage
        int step = 0;
        for (int item = blockIdx.x; item < items; item += gridDim.x) {
          const int q_lo = (item % n_tiles) * C::kRows, b = item / n_tiles / p.H;
          int kv0;
          const int steps = kv_walk(p, q_lo, min(q_lo + C::kRows, p.S) - 1, w2, &kv0);
          for (int i = 0; i < steps; ++i, ++step, kv0 += kWalk)
            rotate_step<D>(pp, step, kv0, p.T, p.rot.cos + b * p.rot.sb, p.rot.sin + b * p.rot.sb, p.rot,
                           ptid - 32);
        }
      }
      return;
    }
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      prefetch_map(&maps.fixed0);
      prefetch_map(&maps.walked0);
    }
    const int tab_half = kRot && !p.rot.interleaved ? p.rot.half : 0;  // table entries per row, staged by TMA
    int step = 0;
    for (int item = blockIdx.x, n = 0; item < items; item += gridDim.x, ++n) {
      const int q_lo = (item % n_tiles) * C::kRows, h = (item / n_tiles) % p.H, b = item / n_tiles / p.H;
      const int tb = p.rot.sb ? b : 0;
      if (lane == 0) produce_item<D>(pp, maps, n, h, q_lo, b);
      int kv0;
      const int steps = kv_walk(p, q_lo, min(q_lo + C::kRows, p.S) - 1, w2, &kv0);
      for (int i = 0; i < steps; ++i, ++step, kv0 += kWalk) {
        // the tile's segment ids (unmasked: one segment; a partial tile is
        // masked), read before waiting for the stage so that the wait hides
        // their latency
        int seg0 = kv0 + lane < p.T, seg1 = kv0 + lane + 32 < p.T;
        if (has_seg) {
          seg0 = seg0 ? __ldg(p.seg_kv + b * p.T + kv0 + lane) : 0;
          seg1 = seg1 ? __ldg(p.seg_kv + b * p.T + kv0 + lane + 32) : 0;
        }
        const int s = produce_wait(pp, step);
        int* seg = pp.template extra<int>(s, 0);
        seg[lane] = seg0;
        seg[lane + 32] = seg1;
        produce_stage<D, kRot>(pp, maps, s, lane, h / group, kv0, b, seg0, seg1, tab_half, tb);
      }
    }
    return;
  }

  if constexpr (C::kShiftRegs) setmaxnreg_inc<C::kConsumerRegs>();
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  int step = 0;
  for (int item = blockIdx.x, n = 0; item < items; item += gridDim.x, ++n) {
    const int q_lo = (item % n_tiles) * C::kRows, h = (item / n_tiles) % p.H, b = item / n_tiles / p.H;
    const int r0 = q_lo + wg * 64 + (t / 32) * 16 + g, r1 = r0 + 8;  // this thread's rows
    const int64_t row0 = (int64_t(b) * p.H + h) * p.S;
    const float nl0 = neg_lse(r0 < p.S ? p.lse[row0 + r0] : kNegInf);
    const float nl1 = neg_lse(r1 < p.S ? p.lse[row0 + r1] : kNegInf);
    int sq0 = 1, sq1 = 1;  // unmasked: one segment
    if (has_seg) {
      sq0 = r0 < p.S ? p.seg_q[b * p.S + r0] : 0;
      sq1 = r1 < p.S ? p.seg_q[b * p.S + r1] : 0;
    }
    // delta = rowsum(dO * O), written for the dkv kernel
    const __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
    const __nv_bfloat16* db = p.dout + b * p.do_sb + h * p.do_sh;
    const float dl0 = quad_sum(row_dot<D>(db, p.do_ss, ob, p.o_ss, r0, p.S, tq));
    const float dl1 = quad_sum(row_dot<D>(db, p.do_ss, ob, p.o_ss, r1, p.S, tq));
    if (tq == 0) {
      if (r0 < p.S) p.delta[row0 + r0] = dl0;
      if (r1 < p.S) p.delta[row0 + r1] = dl1;
    }
    const float* tcos = kRot ? p.rot.cos + b * p.rot.sb : nullptr;
    const float* tsin = kRot ? p.rot.sin + b * p.rot.sb : nullptr;

    const int slot = n % C::kSlots;
    mbar_wait(pp.slot_full(slot), (n / C::kSlots) & 1);
    const uint32_t q_s = pp.slot(slot), do_s = q_s + C::kFixedBytes;
    if constexpr (kRot) {  // this warpgroup's q rows, once per item
      rotate_rows<D>(pp.slot_ptr(slot), C::kRows, q_lo, p.S, tcos, tsin, p.rot, t, 128, wg * 64, wg * 64 + 64);
      fence_proxy_async();
      named_bar_sync(2 + wg);
    }

    float acc[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    int kv0;
    const int steps = kv_walk(p, q_lo, min(q_lo + C::kRows, p.S) - 1, w2, &kv0);
    for (int i = 0; i < steps; ++i, ++step, kv0 += kWalk) {
      const int s = step % C::kStages;
      mbar_wait(pp.full(s), (step / C::kStages) & 1);
      const uint32_t k_s = pp.stage(s), v_s = k_s + C::kWalkBytes;
      float sc[8][4], dp[8][4];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(sc, kmajor_desc(q_s, C::kRows, wg, kk), kmajor_desc(k_s, kWalk, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dp, kmajor_desc(do_s, C::kRows, wg, kk), kmajor_desc(v_s, kWalk, 0, kk), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      fence_acc(dp);

      // ds = p * (dp - delta) * softmax_scale, written over sc; a warp whose
      // rows all share the kv tile's one segment, with no band, takes the
      // branch-free form
      const int uni = *pp.template extra<int>(s, 3);
      if (__all_sync(0xffffffffu, !p.causal && w2 < 0 && uni > 0 && sq0 == uni && sq1 == uni)) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pij = exp2f(fmaf(sc[j][e], p.c, e < 2 ? nl0 : nl1));
            sc[j][e] = pij * (dp[j][e] - (e < 2 ? dl0 : dl1)) * p.sm_scale;
          }
      } else {
        const int* seg = pp.template extra<int>(s, 0);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int cl = j * 8 + tq * 2 + (e & 1), col = kv0 + cl;
            const bool top = e < 2;
            bool ok = col < p.T && in_band(top ? r0 : r1, col, p.causal, p.causal_offset, w2);
            if (has_seg) ok = ok && (top ? sq0 : sq1) == seg[cl] && seg[cl] != 0;
            const float pij = ok ? exp2f(fmaf(sc[j][e], p.c, top ? nl0 : nl1)) : 0.f;
            sc[j][e] = pij * (dp[j][e] - (top ? dl0 : dl1)) * p.sm_scale;
          }
      }
      uint32_t a[4][4];
      to_frag(a, sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(acc, a[kk], mnmajor_desc(k_s, kk));  // dq += bf16(ds) k
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      fence_frag(a);
      if (lane == 0) mbar_arrive(pp.empty(s));  // this warp is done with the stage
    }
    if (lane == 0) mbar_arrive(pp.slot_empty(slot));

    if constexpr (kRot) rotate_adjoint<D>(acc, tcos, tsin, r0, tq, p.rot, p.S);  // dq wrt the unrotated q
    const int64_t row_stride = int64_t(p.H) * D;
    store_rows<D>(p.dq + int64_t(b) * p.S * row_stride + int64_t(h) * D, row_stride, acc, r0, p.S, tq);
  }
}

// dk, dv for items (b, kv head, tile of kRows kv rows). fixed: k, v; walked:
// q, dO of each q head of the GQA group, with the q tile's -LSE, delta and
// segment ids.
template <int D, int kC, bool kRot>
__global__ void __launch_bounds__(Cfg<D, kC, kRot>::kThreads, Cfg<D, kC, kRot>::kBlocksPerSM)
    flash_bwd_dkv_kernel(const __grid_constant__ Maps maps, const BwdParams p) {
  using C = Cfg<D, kC, kRot>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const Pipe<C> pp = pipe_init<C>(smem);
  const int n_tiles = (p.T + C::kRows - 1) / C::kRows, items = p.B * p.Hkv * n_tiles;
  const int group = p.H / p.Hkv, w2 = p.window > 0 ? p.window / 2 : -1;
  const bool has_seg = p.seg_q != nullptr;

  if (threadIdx.x >= C::kConsumerThreads) {  // the producer warpgroup: a loading warp, three rotators
    if constexpr (C::kShiftRegs) setmaxnreg_dec<C::kProducerRegs>();
    const int ptid = threadIdx.x - C::kConsumerThreads;
    if (ptid >= 32) {
      if constexpr (kRot) {  // the q tiles' rows, once per stage
        int step = 0;
        for (int item = blockIdx.x; item < items; item += gridDim.x) {
          const int kv_lo = (item % n_tiles) * C::kRows, b = item / n_tiles / p.Hkv;
          int q_begin;
          const int steps = q_walk(p, kv_lo, min(kv_lo + C::kRows, p.T) - 1, w2, &q_begin);
          for (int m = 0; m < group; ++m)
            for (int i = 0, q0 = q_begin; i < steps; ++i, ++step, q0 += kWalk)
              rotate_step<D>(pp, step, q0, p.S, p.rot.cos + b * p.rot.sb, p.rot.sin + b * p.rot.sb, p.rot,
                             ptid - 32);
        }
      }
      return;
    }
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      prefetch_map(&maps.fixed0);
      prefetch_map(&maps.walked0);
    }
    const int tab_half = kRot && !p.rot.interleaved ? p.rot.half : 0;  // table entries per row, staged by TMA
    int step = 0;
    for (int item = blockIdx.x, n = 0; item < items; item += gridDim.x, ++n) {
      const int kv_lo = (item % n_tiles) * C::kRows, hk = (item / n_tiles) % p.Hkv, b = item / n_tiles / p.Hkv;
      const int tb = p.rot.sb ? b : 0;
      if (lane == 0) produce_item<D>(pp, maps, n, hk, kv_lo, b);
      int q_begin;
      const int steps = q_walk(p, kv_lo, min(kv_lo + C::kRows, p.T) - 1, w2, &q_begin);
      for (int m = 0; m < group; ++m) {
        const int h = hk * group + m;
        const int64_t row0 = (int64_t(b) * p.H + h) * p.S;
        for (int i = 0, q0 = q_begin; i < steps; ++i, ++step, q0 += kWalk) {
          // the q tile's per-row values (rows past S are dead: -LSE = -inf),
          // read before waiting for the stage so that the wait hides their
          // latency
          float nl[2], dl[2];
          int sg[2];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int qr = q0 + lane + 32 * k;
            const bool in = qr < p.S;
            nl[k] = in ? __ldg(p.lse + row0 + qr) : kNegInf;
            dl[k] = in ? __ldg(p.delta + row0 + qr) : 0.f;
            sg[k] = !in ? 0 : has_seg ? __ldg(p.seg_q + b * p.S + qr) : 1;
          }
          const int s = produce_wait(pp, step);
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            pp.template extra<float>(s, 0)[lane + 32 * k] = neg_lse(nl[k]);
            pp.template extra<float>(s, 1)[lane + 32 * k] = dl[k];
            pp.template extra<int>(s, 2)[lane + 32 * k] = sg[k];
          }
          produce_stage<D, kRot>(pp, maps, s, lane, h, q0, b, sg[0], sg[1], tab_half, tb);
        }
      }
    }
    return;
  }

  if constexpr (C::kShiftRegs) setmaxnreg_inc<C::kConsumerRegs>();
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  int step = 0;
  for (int item = blockIdx.x, n = 0; item < items; item += gridDim.x, ++n) {
    const int kv_lo = (item % n_tiles) * C::kRows, hk = (item / n_tiles) % p.Hkv, b = item / n_tiles / p.Hkv;
    const int r0 = kv_lo + wg * 64 + (t / 32) * 16 + g, r1 = r0 + 8;  // this thread's kv rows
    int skv0 = r0 < p.T, skv1 = r1 < p.T;  // unmasked: one segment
    if (has_seg) {
      skv0 = r0 < p.T ? p.seg_kv[b * p.T + r0] : 0;
      skv1 = r1 < p.T ? p.seg_kv[b * p.T + r1] : 0;
    }
    const float* tcos = kRot ? p.rot.cos + b * p.rot.sb : nullptr;
    const float* tsin = kRot ? p.rot.sin + b * p.rot.sb : nullptr;

    const int slot = n % C::kSlots;
    mbar_wait(pp.slot_full(slot), (n / C::kSlots) & 1);
    const uint32_t k_s = pp.slot(slot), v_s = k_s + C::kFixedBytes;
    if constexpr (kRot) {  // this warpgroup's k rows, once per item
      rotate_rows<D>(pp.slot_ptr(slot), C::kRows, kv_lo, p.T, tcos, tsin, p.rot, t, 128, wg * 64, wg * 64 + 64);
      fence_proxy_async();
      named_bar_sync(2 + wg);
    }

    float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
      dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
    }
    int q_begin;
    const int steps = q_walk(p, kv_lo, min(kv_lo + C::kRows, p.T) - 1, w2, &q_begin);
    for (int m = 0; m < group; ++m) {
      for (int i = 0, q0 = q_begin; i < steps; ++i, ++step, q0 += kWalk) {
        const int s = step % C::kStages;
        mbar_wait(pp.full(s), (step / C::kStages) & 1);
        const uint32_t q_s = pp.stage(s), do_s = q_s + C::kWalkBytes;
        const float* nlse = pp.template extra<float>(s, 0);
        const float* delta = pp.template extra<float>(s, 1);
        const int* seg = pp.template extra<int>(s, 2);
        // transposed products: rows are this warpgroup's kv rows, columns q rows
        float st[8][4], dpt[8][4];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(st, kmajor_desc(k_s, C::kRows, wg, kk), kmajor_desc(q_s, kWalk, 0, kk), kk);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(dpt, kmajor_desc(v_s, C::kRows, wg, kk), kmajor_desc(do_s, kWalk, 0, kk), kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(st);
        fence_acc(dpt);

        // p^T over st, ds^T over dpt; a warp whose kv rows all share the q
        // tile's one segment, with no band, takes the branch-free form
        const int uni = *pp.template extra<int>(s, 3);
        if (__all_sync(0xffffffffu, !p.causal && w2 < 0 && uni > 0 && skv0 == uni && skv1 == uni)) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            // this thread's two q rows (columns) of block j: their -LSE and delta
            const float2 nl = *reinterpret_cast<const float2*>(nlse + j * 8 + tq * 2);
            const float2 dl = *reinterpret_cast<const float2*>(delta + j * 8 + tq * 2);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float pij = exp2f(fmaf(st[j][e], p.c, e & 1 ? nl.y : nl.x));
              st[j][e] = pij;
              dpt[j][e] = pij * (dpt[j][e] - (e & 1 ? dl.y : dl.x)) * p.sm_scale;
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int cl = j * 8 + tq * 2 + (e & 1), kvr = e < 2 ? r0 : r1, skv = e < 2 ? skv0 : skv1;
              const bool ok = kvr < p.T && in_band(q0 + cl, kvr, p.causal, p.causal_offset, w2) && seg[cl] == skv &&
                              skv != 0;
              const float pij = ok ? exp2f(fmaf(st[j][e], p.c, nlse[cl])) : 0.f;
              st[j][e] = pij;
              dpt[j][e] = pij * (dpt[j][e] - delta[cl]) * p.sm_scale;
            }
        }
        uint32_t pa[4][4], da[4][4];
        to_frag(pa, st);
        to_frag(da, dpt);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dv, pa[kk], mnmajor_desc(do_s, kk));  // dv += bf16(p)^T dO
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dk, da[kk], mnmajor_desc(q_s, kk));   // dk += bf16(ds)^T q
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(dv);
        fence_acc(dk);
        fence_frag(pa);
        fence_frag(da);
        if (lane == 0) mbar_arrive(pp.empty(s));  // this warp is done with the stage
      }
    }
    if (lane == 0) mbar_arrive(pp.slot_empty(slot));

    const int64_t row_stride = int64_t(p.Hkv) * D;
    const int64_t base = int64_t(b) * p.T * row_stride + int64_t(hk) * D;
    store_rows<D>(p.dv + base, row_stride, dv, r0, p.T, tq);
    if constexpr (kRot) rotate_adjoint<D>(dk, tcos, tsin, r0, tq, p.rot, p.T);  // dk wrt the unrotated k
    store_rows<D>(p.dk + base, row_stride, dk, r0, p.T, tq);
  }
}

// ---- host side ----------------------------------------------------------------

// The tensor map of a [B, n_rows, heads, D] bf16 operand with strides (batch,
// row, head) in elements, for tiles of box_rows rows of one head.
bool operand_map(CUtensorMap* map, const void* ptr, int D, int heads, int n_rows, int B, int64_t sb, int64_t ss,
                 int64_t sh, int box_rows) {
  const int64_t dims[4] = {D, heads, n_rows, B}, strides[3] = {sh, ss, sb};
  const int box[4] = {64, 1, box_rows, 1};
  return make_map(map, ptr, 4, dims, strides, box);
}

// The map of an expanded fp32 NeoX rotary table ([rows, D], or [B, rows, D]
// with batch stride sb elements; rows = S rounded up to kWalk, as the
// wrapper pads them), no swizzle, whose box is the first `half` columns
// (one entry per rotated pair) of kWalk rows.
bool table_map(CUtensorMap* map, const void* table, int D, int S, int B, int64_t sb, int half) {
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
bool rotary_maps(Maps* maps, const BwdParams& p, int D) {
  return p.rot.cos == nullptr || p.rot.interleaved ||
         (table_map(&maps->cos, p.rot.cos, D, p.S, p.B, p.rot.sb, p.rot.half) &&
          table_map(&maps->sin, p.rot.sin, D, p.S, p.B, p.rot.sb, p.rot.half));
}

BwdParams make_params(const void* o, const void* dout, const void* lse, void* delta, const void* seg_q,
                      const void* seg_kv, int B, int S, int T, int H, int Hkv, int64_t o_sb, int64_t o_ss,
                      int64_t o_sh, int64_t do_sb, int64_t do_ss, int64_t do_sh, int causal, int causal_offset,
                      int window, float c, float sm_scale, const void* rot_cos, const void* rot_sin,
                      int64_t rot_sb, int rot_half, int rot_interleaved) {
  BwdParams p = {};
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_kv = static_cast<const int*>(seg_kv);
  p.B = B; p.S = S; p.T = T; p.H = H; p.Hkv = Hkv;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.do_sb = do_sb; p.do_ss = do_ss; p.do_sh = do_sh;
  p.causal = causal; p.causal_offset = causal_offset; p.window = window;
  p.c = c;
  p.sm_scale = sm_scale;
  p.rot = Rotary{static_cast<const float*>(rot_cos), static_cast<const float*>(rot_sin), rot_sb, rot_half,
                 rot_interleaved};
  return p;
}

// Cfg::kSmemBytes of dynamic shared memory (above the 48 KB default:
// allowed once per kernel); a persistent grid of kBlocksPerSM blocks per SM,
// at most one per item.
template <class C>
cudaError_t launch(void (*kernel)(Maps, BwdParams), bool* ready, const Maps& maps, const BwdParams& p, int items,
                   cudaStream_t st) {
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

template <int D, int kC, bool kRot>
cudaError_t launch_dq(const Maps& maps, const BwdParams& p, cudaStream_t st) {
  using C = Cfg<D, kC, kRot>;
  static bool ready = false;
  const int items = p.B * p.H * ((p.S + C::kRows - 1) / C::kRows);
  return launch<C>(flash_bwd_dq_kernel<D, kC, kRot>, &ready, maps, p, items, st);
}

template <int D, int kC, bool kRot>
cudaError_t launch_dkv(const Maps& maps, const BwdParams& p, cudaStream_t st) {
  using C = Cfg<D, kC, kRot>;
  static bool ready = false;
  const int items = p.B * p.Hkv * ((p.T + C::kRows - 1) / C::kRows);
  return launch<C>(flash_bwd_dkv_kernel<D, kC, kRot>, &ready, maps, p, items, st);
}

// Rows of an item: 128 (two warpgroups) at D = 64 when the item's rows
// (S for dq, T for dk/dv) fill more than one warpgroup, else 64.
int item_rows(int D, int n_rows) { return D == 64 && n_rows > 64 ? 128 : 64; }

}  // namespace

// C entry points, loaded with ctypes. Each launches on `stream`, does not
// synchronise and allocates nothing; each returns cudaGetLastError() (or
// the error that stopped it first) so the caller sees a refused launch
// (bad shape, too many resources) at once. q, k, v, O and dO: unit stride
// over D, other strides and the pointers 16-byte aligned (TMA; the wrapper
// checks). rot_cos == NULL runs the plain variant; otherwise the
// fused-rotary one, with the tables and rules of flash_fwd_bf16 (S == T,
// rot_half % 8 == 0).
//
// flash_bwd_dq_bf16 writes dq and delta = rowsum(dO * O) [B, H, S] fp32;
// flash_bwd_dkv_bf16 reads that delta, so it runs after dq on one stream.
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout, const void* o,
                                 const void* lse, void* delta, void* dq, const void* seg_q, const void* seg_kv,
                                 int B, int S, int T, int H, int Hkv, int D, int64_t q_sb, int64_t q_ss,
                                 int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                                 int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh, int64_t do_sb,
                                 int64_t do_ss, int64_t do_sh, int causal, int causal_offset, int window, float c,
                                 float sm_scale, const void* rot_cos, const void* rot_sin, int64_t rot_sb,
                                 int rot_half, int rot_interleaved, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || (D != 64 && D != 128) || !rot_ok(rot_cos, rot_half, D))
    return int(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || H == 0) return int(cudaSuccess);
  BwdParams p = make_params(o, dout, lse, delta, seg_q, seg_kv, B, S, T, H, Hkv, o_sb, o_ss, o_sh, do_sb, do_ss,
                            do_sh, causal, causal_offset, window, c, sm_scale, rot_cos, rot_sin, rot_sb, rot_half,
                            rot_interleaved);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  const int rows = item_rows(D, S);
  Maps maps = {};
  if (!operand_map(&maps.fixed0, q, D, H, S, B, q_sb, q_ss, q_sh, rows) ||
      !operand_map(&maps.fixed1, dout, D, H, S, B, do_sb, do_ss, do_sh, rows) || !rotary_maps(&maps, p, D))
    return int(cudaErrorInvalidValue);
  if (T == 0) {  // no kv tile is loaded: every row gets dq = 0 and its delta
    maps.walked0 = maps.walked1 = maps.fixed0;
  } else if (!operand_map(&maps.walked0, k, D, Hkv, T, B, k_sb, k_ss, k_sh, kWalk) ||
             !operand_map(&maps.walked1, v, D, Hkv, T, B, v_sb, v_ss, v_sh, kWalk)) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fused = rot_cos != nullptr;
  if (D == 128) return int(fused ? launch_dq<128, 1, true>(maps, p, s) : launch_dq<128, 1, false>(maps, p, s));
  if (rows == 64) return int(fused ? launch_dq<64, 1, true>(maps, p, s) : launch_dq<64, 1, false>(maps, p, s));
  return int(fused ? launch_dq<64, 2, true>(maps, p, s) : launch_dq<64, 2, false>(maps, p, s));
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv, const void* seg_q, const void* seg_kv,
                                  int B, int S, int T, int H, int Hkv, int D, int64_t q_sb, int64_t q_ss,
                                  int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                                  int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh, int causal,
                                  int causal_offset, int window, float c, float sm_scale, const void* rot_cos,
                                  const void* rot_sin, int64_t rot_sb, int rot_half, int rot_interleaved,
                                  void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || (D != 64 && D != 128) || !rot_ok(rot_cos, rot_half, D))
    return int(cudaErrorInvalidValue);
  if (B == 0 || T == 0 || Hkv == 0) return int(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S == 0 || H == 0) {  // no q row: dk = dv = 0
    const size_t bytes = size_t(B) * T * Hkv * D * sizeof(__nv_bfloat16);
    const cudaError_t err = cudaMemsetAsync(dk, 0, bytes, s);
    return int(err != cudaSuccess ? err : cudaMemsetAsync(dv, 0, bytes, s));
  }
  BwdParams p = make_params(nullptr, dout, lse, const_cast<void*>(delta), seg_q, seg_kv, B, S, T, H, Hkv, 0, 0, 0,
                            o_sb, o_ss, o_sh, causal, causal_offset, window, c, sm_scale, rot_cos, rot_sin, rot_sb,
                            rot_half, rot_interleaved);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  const int rows = item_rows(D, T);
  Maps maps = {};
  if (!operand_map(&maps.fixed0, k, D, Hkv, T, B, k_sb, k_ss, k_sh, rows) ||
      !operand_map(&maps.fixed1, v, D, Hkv, T, B, v_sb, v_ss, v_sh, rows) ||
      !operand_map(&maps.walked0, q, D, H, S, B, q_sb, q_ss, q_sh, kWalk) ||
      !operand_map(&maps.walked1, dout, D, H, S, B, o_sb, o_ss, o_sh, kWalk) || !rotary_maps(&maps, p, D))
    return int(cudaErrorInvalidValue);
  const bool fused = rot_cos != nullptr;
  if (D == 128) return int(fused ? launch_dkv<128, 1, true>(maps, p, s) : launch_dkv<128, 1, false>(maps, p, s));
  if (rows == 64) return int(fused ? launch_dkv<64, 1, true>(maps, p, s) : launch_dkv<64, 1, false>(maps, p, s));
  return int(fused ? launch_dkv<64, 2, true>(maps, p, s) : launch_dkv<64, 2, false>(maps, p, s));
}
