// One instantiation set of the fused sub-step kernel: the kernel for
// GMIX_Q lane groups (a mixer row of up to 32 * GMIX_Q lanes) with the
// byte's look-up tables in shared memory (GMIX_TABLES=1) or left in global
// memory (0), with and without stage clocks. utils/build.py compiles this
// file once per pair, all at the same time; fused.cu picks among them at
// launch.
#include "fused_kernel.cuh"

#if !defined(GMIX_Q) || !defined(GMIX_TABLES)
#error "compile with -DGMIX_Q=1, 2, 4, 8 or 16 and -DGMIX_TABLES=0 or 1"
#endif

namespace gmix {

namespace {

// The dynamic shared-memory limit is an attribute of the current device's
// context: it is raised once per device and instantiation, before the first
// launch on that device (or before a CUDA graph capture records one: the
// capture only records).
int raise_smem_limit(bool clocks) {
  constexpr int kMaxDevices = 64;
  static bool raised[kMaxDevices][2] = {};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!raised[dev][clocks]) {
    auto kernel = clocks ? fused_substeps_kernel<GMIX_Q, GMIX_TABLES != 0, true>
                         : fused_substeps_kernel<GMIX_Q, GMIX_TABLES != 0, false>;
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    raised[dev][clocks] = true;
  }
  return 0;
}

}  // namespace

template <>
int launch_fused_variant<GMIX_Q, GMIX_TABLES != 0>(const Dims& d, const FusedIO& io, size_t smem_bytes, bool clocks,
                                                   cudaStream_t stream) {
  if (int rc = raise_smem_limit(clocks)) return rc;
  auto kernel = clocks ? fused_substeps_kernel<GMIX_Q, GMIX_TABLES != 0, true>
                       : fused_substeps_kernel<GMIX_Q, GMIX_TABLES != 0, false>;
  kernel<<<static_cast<unsigned int>(d.S), kThreads, smem_bytes, stream>>>(d, io);
  return static_cast<int>(cudaGetLastError());
}

template <>
int prepare_fused_variant<GMIX_Q, GMIX_TABLES != 0>() {
  return raise_smem_limit(false);
}

}  // namespace gmix
