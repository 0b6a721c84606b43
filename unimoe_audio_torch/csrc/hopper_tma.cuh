// Host side of the Hopper kernels: tensor maps for bf16 tensors, encoded by
// libcuda's cuTensorMapEncodeTiled, which is looked up through the CUDA
// runtime so that a library including this header needs no link against
// libcuda; and `PerDevice`, which sets a kernel's attributes once per device.
//
// A map describes a contiguous bf16 tensor of up to 3 dimensions (innermost
// first) cut into boxes of the given size, in the 128-byte swizzled layout
// of hopper_ptx.cuh (the inner box dimension is at most 64 elements), with
// elements out of bounds filled with zeros.  A coordinate past a dimension's
// end reads zeros and never the next slice of an outer dimension.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace hopper {

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

constexpr int ENCODE_FAILED = 10000;    // + the CUresult of a failed encode

// Encodes `map` for the contiguous bf16 tensor at ptr with `rank` dims
// (innermost first) and boxes of box[0] x box[1] (x box[2]) elements.
// Returns 0, or ENCODE_FAILED + the CUresult.
inline int encode(CUtensorMap* map, const void* ptr, int rank, const uint64_t* dims,
                  const uint32_t* box) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return ENCODE_FAILED + (int)CUDA_ERROR_NOT_FOUND;
  cuuint64_t gdim[3], gstride[2];
  cuuint32_t bdim[3], estride[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    bdim[i] = box[i];
  }
  gstride[0] = dims[0] * 2;
  if (rank > 2) gstride[1] = dims[0] * dims[1] * 2;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), gdim,
                        gstride, bdim, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + (int)r;
}

// A kernel's attributes (such as its dynamic shared-memory limit) belong to
// each device's context: `once(set)` runs `set` (returning a cudaError_t) on
// the current device the first time that device launches the kernel, and
// again after a failure.  One static instance per kernel; devices past 63 set
// it on every launch.
class PerDevice {
 public:
  template <typename Set>
  cudaError_t once(Set set) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
    if (bit & done_.load(std::memory_order_acquire)) return cudaSuccess;
    e = set();
    if (e == cudaSuccess) done_.fetch_or(bit, std::memory_order_acq_rel);
    return e;
  }

 private:
  std::atomic<unsigned long long> done_{0};
};

}  // namespace hopper
