// Hopper (sm_90a) building blocks shared by gmm.cu and the flash kernels: shared
// memory addresses, mbarriers, TMA loads and stores (cp.async.bulk.tensor),
// the proxy fence, named barriers, register budgets (setmaxnreg), wgmma
// descriptors and its fence / commit / wait, and on the host the tensor-map encoder reached through the
// runtime's driver entry point (no -lcuda) and the SM count.
#pragma once

#include <cuda.h>  // CUtensorMap and the tensor-map encoder's types (header only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---- shared memory, mbarriers, TMA, wgmma -------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed. A fresh barrier
// is in phase 0: waiting on parity 1 passes at once.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// Barriers are set up by one thread; this makes them visible to the
// async proxy (TMA) before anyone uses them.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// Wait until at most kPending bulk stores of this thread still read shared memory.
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending) : "memory");
}

// Generic-proxy writes to shared memory, before the async proxy (TMA,
// wgmma's operand reads) reads them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier of `threads` threads (a multiple of 32) on barrier `id`; 0 is
// __syncthreads.
__device__ __forceinline__ void named_bar_sync(int id, int threads = 128) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Arrive on barrier `id` of `threads` threads without waiting: the other
// side of a named_bar_sync.
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Warp-specialised register budgets: every warp of a warpgroup lowers
// (dec) or raises (inc) its per-thread register count together.
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 (B128).
//   K-major (rows of 64 bf16 along the contraction, 128 B apart): stride
//     offset 1024 B between 8-row groups; the leading offset is unused; a
//     16-deep step adds 32 B to the start.
//   MN-major (rows of 64 bf16 along M or N, one per contraction index,
//     128 B apart, 64-wide boxes 8 KB apart): leading offset 8 KB between
//     the boxes along M/N, stride offset 1024 B between 8-deep groups; a
//     16-deep step adds 2048 B.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lead, uint32_t stride) {
  return uint64_t((addr & 0x3FFFF) >> 4) | uint64_t((lead >> 4) & 0x3FFF) << 16 |
         uint64_t((stride >> 4) & 0x3FFF) << 32 | uint64_t(1) << 62;
}
constexpr uint32_t kKMajorStep = 32, kMNMajorStep = 2048;

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// ---- host side ----------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Bind the current device's primary context to the calling thread. A driver
// call such as cuTensorMapEncodeTiled needs a current context and fails
// without one (CUDA_ERROR_INVALID_CONTEXT). The runtime binds its primary
// context to a thread only at the thread's first runtime call that needs a
// context, so a thread that has made none has no current context: PyTorch's
// autograd device thread is one until it launches something, since its
// set_device skips cudaSetDevice when the device is already current (device
// 0), and a backward can begin with a tensor-map encode (gmm's dlhs in a
// fresh process does). cudaSetDevice binds the primary context (CUDA 12);
// it is called once per thread and device.
inline cudaError_t bind_context() {
  static thread_local int bound = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev != bound && (err = cudaSetDevice(dev)) == cudaSuccess) bound = dev;
  return err;
}

// cuTensorMapEncodeTiled is a driver API function: reached through the
// runtime's driver entry point, so the library links no -lcuda. The
// encoder is returned with the device's context current on this thread
// (`bind_context`); nullptr if either fails.
inline EncodeTiled encode_tiled() {
  if (bind_context() != cudaSuccess) return nullptr;
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map with 128-byte swizzle (rank <= 5); dims innermost
// first, strides in elements (of dims 1..rank-1). Out-of-range elements
// load as zeros.
inline bool make_map(CUtensorMap* map, const void* ptr, int rank, const int64_t* dims, const int64_t* strides,
                     const int* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || rank < 1 || rank > 5) return false;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], unit[5] = {1, 1, 1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = cuuint64_t(dims[i]);
    b[i] = cuuint32_t(box[i]);
    if (i > 0) s[i - 1] = cuuint64_t(strides[i - 1]) * sizeof(__nv_bfloat16);
  }
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, cuuint32_t(rank), const_cast<void*>(ptr), d, s, b, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// SMs of the current device: the size of a persistent grid.
inline cudaError_t sm_count(int* n) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  return err == cudaSuccess ? cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev) : err;
}

}  // namespace hopper
