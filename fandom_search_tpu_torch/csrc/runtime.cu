// Shared C entry points of libfs_kernels.so: error strings for the
// codes the kernel entry points return (each returns cudaGetLastError()).
#include <cuda_runtime.h>

extern "C" const char* fs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
