// Error text for the C launchers' return codes (cudaError_t).
#include <cuda_runtime.h>

extern "C" const char* de_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
