// Alignment-window identity counts, one warp per alignment record.
//
// Replaces carpedeam_tpu/ops/window_pallas.py::_ident_kernel (:45),
// launched there by _window_identity_device (:78).  For each record the
// target row is read in the query frame (column p compares q[p] with
// t[(p + tstart - qstart) mod L]) and the exact-character and RY-class
// identity counts are taken over [qstart, qstart + win) within the row.
//
// Bound on the H100: bytes.  A record touches two window slices of the
// symbol planes and writes 8 bytes; the work is two compares and two
// adds per column.  The TPU kernel rotated the whole target row with a
// barrel shifter; here consecutive lanes load consecutive window bytes
// by direct index, only the window is read (not the whole row), and the
// counts are integer warp reductions, exact in any order.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
window_identity_kernel(const uint8_t* __restrict__ sym2, int32_t L,
                       const int32_t* __restrict__ qrow,
                       const int32_t* __restrict__ trow,
                       const int32_t* __restrict__ scal, int64_t n,
                       int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= n) return;
  const uint8_t* q = sym2 + static_cast<int64_t>(qrow[r]) * L;
  const uint8_t* t = sym2 + static_cast<int64_t>(trow[r]) * L;
  const int32_t qstart = scal[4 * r];
  const int32_t tstart = scal[4 * r + 1];
  const int32_t win = scal[4 * r + 2];
  const int32_t shift = cd::wrap(static_cast<int64_t>(tstart) - qstart, L);
  const int32_t lo = max(qstart, 0);
  const int32_t hi = min(qstart + win, L);
  int idc = 0, ryc = 0;
  for (int32_t p = lo + lane; p < hi; p += 32) {
    const int a = q[p];
    const int b = t[cd::wrap(static_cast<int64_t>(p) + shift, L)];
    idc += a == b;
    ryc += cd::is_ct(a) == cd::is_ct(b);
  }
  idc = __reduce_add_sync(cd::kFullMask, idc);
  ryc = __reduce_add_sync(cd::kFullMask, ryc);
  if (lane == 0) {
    out[2 * r] = idc;
    out[2 * r + 1] = ryc;
  }
}

}  // namespace

CD_EXPORT int cd_window_identity(const void* sym2, int64_t L,
                                 const void* qrow, const void* trow,
                                 const void* scal, int64_t n, void* out,
                                 void* stream) {
  if (n > 0) {
    const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    window_identity_kernel<<<static_cast<unsigned>(blocks),
                             32 * kWarpsPerBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(sym2), static_cast<int32_t>(L),
        static_cast<const int32_t*>(qrow), static_cast<const int32_t*>(trow),
        static_cast<const int32_t*>(scal), n, static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
