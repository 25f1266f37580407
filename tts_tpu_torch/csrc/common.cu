// C entry point shared by the wrappers: the message for an error code that a
// kernel entry point returned.
#include <cuda_runtime.h>

extern "C" const char* tts_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
