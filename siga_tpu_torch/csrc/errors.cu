// Error text for the codes the other entry points return.
#include <cuda_runtime.h>

extern "C" const char* siga_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
