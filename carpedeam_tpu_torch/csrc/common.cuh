// Shared helpers of the carpedeam_tpu_torch CUDA kernels.
//
// Every kernel is exported through a plain C function that takes device
// pointers, sizes and a cudaStream_t (as void*), launches on that stream
// and returns cudaGetLastError(); the Python wrappers (ops/*_cuda.py)
// load the library with ctypes and raise on a non-zero return.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define CD_EXPORT extern "C" __attribute__((visibility("default")))

namespace cd {

constexpr unsigned kFullMask = 0xffffffffu;

// x mod m in [0, m) for any sign of x (m > 0): the row rotation of the
// TPU kernels' barrel shifter, written as a direct index.
__device__ __forceinline__ int32_t wrap(int64_t x, int32_t m) {
  int64_t r = x % m;
  return static_cast<int32_t>(r < 0 ? r + m : r);
}

// RY class of a case-folded symbol byte: pyrimidine C/T vs the rest.
__device__ __forceinline__ bool is_ct(int c) { return c == 'C' || c == 'T'; }

// A0 C1 G2 T3, anything else 0 (the reference's CHAR_TO_ACGT default).
__device__ __forceinline__ int acgt_code(int c) {
  return c == 'C' ? 1 : c == 'G' ? 2 : c == 'T' ? 3 : 0;
}

}  // namespace cd
