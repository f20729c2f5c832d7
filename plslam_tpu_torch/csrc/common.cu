// Shared C entry of the kernel library: CUDA error text for the wrappers.
#include <cuda_runtime.h>

extern "C" const char* plslam_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
