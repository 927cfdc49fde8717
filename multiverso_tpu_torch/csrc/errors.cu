// Error text for the cudaError_t codes the kernels' C entry points
// return (the wrappers raise with it).

#include <cuda_runtime.h>

extern "C" const char* mv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
