// The host-memory value tier's runtime calls (no kernel): pinned, mapped
// host memory for an 'hmem' value plane, and the device pointer under which
// the kernels reach it over the host link.
//
// The reference places an 'hmem' plane with device_put(memory_kind=
// 'pinned_host') (src/repro/core/table.py:168).  Here the plane is one
// cudaHostAlloc allocation, page-locked and mapped into the device's
// address space (the paper's zero-copy HMEM tier, §3.6): a kernel that
// reads or writes a row of it moves only that row over PCIe.  It is
// allocated here rather than through PyTorch's caching host allocator so
// that it takes exactly the plane's bytes and is pinned where it is made,
// with no pageable copy first (that allocator rounds a block up to a power
// of two: torch 2.11 gave a 0.75 GiB pinned tensor a 1 GiB block on an
// H100 host).
#include <cstdint>
#include <cuda_runtime.h>

// A failed call leaves its error for the next cudaGetLastError, which is how
// the kernels' entry points report a launch: clear it here.
static int cleared(cudaError_t e) {
  if (e != cudaSuccess) cudaGetLastError();
  return static_cast<int>(e);
}

extern "C" int hkv_host_alloc(void** ptr, int64_t bytes) {
  return cleared(
      cudaHostAlloc(ptr, static_cast<size_t>(bytes), cudaHostAllocMapped | cudaHostAllocPortable));
}

extern "C" int hkv_host_free(void* ptr) { return cleared(cudaFreeHost(ptr)); }

// The device pointer of pinned host memory; fails for memory that is not.
extern "C" int hkv_host_device_pointer(void* host, void** device) {
  return cleared(cudaHostGetDevicePointer(device, host, 0));
}

extern "C" int hkv_device_attribute(int attr, int device, int* value) {
  return cleared(cudaDeviceGetAttribute(value, static_cast<cudaDeviceAttr>(attr), device));
}
