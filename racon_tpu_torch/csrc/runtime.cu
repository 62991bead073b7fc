// Error text for the codes the kernels' C entry points return.

#include <cuda_runtime.h>

extern "C" const char* rt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
