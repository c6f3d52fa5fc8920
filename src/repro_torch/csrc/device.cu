// What the wrappers ask of the card before they size a launch, and the
// launch floor that every kernel's time is read against.
#include <cuda_runtime.h>

// The most dynamic shared memory one block of `device` may opt in to
// (cudaDevAttrMaxSharedMemoryPerBlockOptin: 232,448 bytes on an H100),
// or -1 if the query fails.
extern "C" int max_shared_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

namespace {

__global__ void empty_kernel() {}

}  // namespace

// One launch of a kernel that does nothing: no kernel call, however
// small its work, takes less time than this.
extern "C" int launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
