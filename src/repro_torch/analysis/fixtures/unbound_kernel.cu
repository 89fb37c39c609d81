// Fixture: a kernel entry no wrapper launches.
//
// kernel_parity.check_kernel_parity pointed at this directory must flag
// hkv_fixture_unbound with rule unbound-kernel: a C entry point that no
// wrapper in repro_torch/kernels calls has no plain version, no parity test
// and no place in chip_smoke.py either.  Never compiled: the build takes
// repro_torch/csrc/*.cu only.
#include <cstdint>

__global__ void fixture_unbound_kernel(const int64_t* in, int64_t* out, int64_t n) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i < n) out[i] = in[i] + 1;
}

extern "C" int hkv_fixture_unbound(const void* in, void* out, int64_t n, void* stream) {
  fixture_unbound_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(in), static_cast<int64_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
