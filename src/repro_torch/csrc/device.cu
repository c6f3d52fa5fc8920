// What the wrappers ask of the card before they size a launch.
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
