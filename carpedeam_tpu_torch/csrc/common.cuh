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

// x mod m for x in (-m, 2m): one conditional add or subtract, 32 bits.
__device__ __forceinline__ int32_t wrap_near(int32_t x, int32_t m) {
  return x < 0 ? x + m : (x >= m ? x - m : x);
}

// Lanes given to one item when its row of L bytes is read in 16-byte
// words: the power of two whose lanes cover the row in two words each, at
// most a warp (4 at L=128: more items in flight hide more of the gathers'
// latency than wider groups would).
__host__ __device__ inline int lanes_for(int64_t L) {
  int s = 1;
  while (s < 32 && static_cast<int64_t>(s) * 32 < L) s *= 2;
  return s;
}

// Mask of the calling lane's group of `s` lanes (s a power of two).
__device__ __forceinline__ unsigned group_mask(int s) {
  if (s == 32) return kFullMask;
  const int lane = threadIdx.x & 31;
  return ((1u << s) - 1u) << (lane & ~(s - 1));
}

// Bytes k < 4 of a word that lie below `n` (n may be <= 0 or > 4).
__device__ __forceinline__ uint32_t head_bytes(int n) {
  return n >= 4 ? 0xffffffffu : (n <= 0 ? 0u : (1u << (8 * n)) - 1u);
}

// Whole bytes (0xff each) of a masked SIMD-compare result, counted.
__device__ __forceinline__ int count_ff(uint4 m) {
  return (__popc(m.x) + __popc(m.y) + __popc(m.z) + __popc(m.w)) >> 3;
}

// The 16 bytes row[col + k], k = 0..15, of an aligned pair of 16-byte
// words: `lo` holds row[col] at byte `s`, `hi` the next 16 bytes.
__device__ __forceinline__ uint4 shift_bytes(uint4 lo, uint4 hi, int s) {
  uint32_t w0 = lo.x, w1 = lo.y, w2 = lo.z, w3 = lo.w;
  uint32_t w4 = hi.x, w5 = hi.y, w6 = hi.z, w7 = hi.w;
  if (s & 8) {
    w0 = w2; w1 = w3; w2 = w4; w3 = w5; w4 = w6; w5 = w7;
  }
  if (s & 4) {
    w0 = w1; w1 = w2; w2 = w3; w3 = w4; w4 = w5;
  }
  const int b = 8 * (s & 3);
  return make_uint4(__funnelshift_r(w0, w1, b), __funnelshift_r(w1, w2, b),
                    __funnelshift_r(w2, w3, b), __funnelshift_r(w3, w4, b));
}

// The bytes at[k], k < nk (1 <= nk <= 16), as one 16-byte value; bytes
// k >= nk are unspecified and must be masked.  Read in aligned 16-byte
// words: the second word is loaded only where a wanted byte lies in it
// (else the first is read again), so no load leaves the 16-byte-aligned
// extent of the plane, and no branch keeps the loads from overlapping.
__device__ __forceinline__ uint4 bytes16(const uint8_t* __restrict__ at,
                                         int nk) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(at);
  const uint4* w = reinterpret_cast<const uint4*>(addr & ~uintptr_t{15});
  const int s = static_cast<int>(addr & 15);
  const uint4 lo = __ldg(w);
  const uint4 hi = __ldg(s + nk > 16 ? w + 1 : w);
  return shift_bytes(lo, hi, s);
}

// Bytes row[(col + k) mod L] for k < nk (0 <= col < L, 1 <= nk <= 16), as
// bytes16 gives them.  A window that runs past the row end wraps to
// column 0 (the TPU kernels' rotation) and is read byte by byte.
__device__ __forceinline__ uint4 window16(const uint8_t* __restrict__ row,
                                          int32_t L, int32_t col, int nk) {
  if (col + nk <= L) return bytes16(row + col, nk);
  uint32_t x[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (k < nk) {
      int32_t c = col + k;
      if (c >= L) c -= L;
      x[k >> 2] |= static_cast<uint32_t>(row[c]) << (8 * (k & 3));
    }
  }
  return make_uint4(x[0], x[1], x[2], x[3]);
}

// Mask of bytes k < nk of a 16-byte value.
__device__ __forceinline__ uint4 tail_mask(int nk) {
  return make_uint4(head_bytes(nk), head_bytes(nk - 4), head_bytes(nk - 8),
                    head_bytes(nk - 12));
}

// RY class of a case-folded symbol byte: pyrimidine C/T vs the rest.
__device__ __forceinline__ bool is_ct(int c) { return c == 'C' || c == 'T'; }

// is_ct of each byte of a word: 0xff where the byte is C or T, else 0.
__device__ __forceinline__ uint32_t is_ct4(uint32_t x) {
  return __vcmpeq4(x, 0x43434343u) | __vcmpeq4(x, 0x54545454u);
}

// A0 C1 G2 T3, anything else 0 (the reference's CHAR_TO_ACGT default).
__device__ __forceinline__ int acgt_code(int c) {
  return c == 'C' ? 1 : c == 'G' ? 2 : c == 'T' ? 3 : 0;
}

// acgt_code of each byte of a word.
__device__ __forceinline__ uint32_t acgt_code4(uint32_t x) {
  return (__vcmpeq4(x, 0x43434343u) & 0x01010101u) |
         (__vcmpeq4(x, 0x47474747u) & 0x02020202u) |
         (__vcmpeq4(x, 0x54545454u) & 0x03030303u);
}

}  // namespace cd
