// Small C helpers shared by the Python bindings (sparenet_tpu_torch/ops/_lib.py).
#include <cuda_runtime.h>

extern "C" const char* spn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
