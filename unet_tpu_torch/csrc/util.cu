// Text of a CUDA error code, for the wrappers' exceptions.

#include <cuda_runtime.h>

extern "C" const char* unet_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
