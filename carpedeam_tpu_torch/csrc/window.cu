// Alignment-window identity counts, one group of lanes per alignment
// record, comparing 16 plane bytes per lane and step.
//
// Replaces carpedeam_tpu/ops/window_pallas.py::_ident_kernel (:45),
// launched there by _window_identity_device (:78).  For each record the
// target row is read in the query frame (column p compares q[p] with
// t[(p + tstart - qstart) mod L]) and the exact-character and RY-class
// identity counts are taken over [qstart, qstart + win) within the row.
//
// Bound on the H100: bytes, and at the read-phase shape the latency of
// the dependent loads (record -> row indices and scalars -> row bytes):
// a record touches two window slices of the symbol planes and writes 8
// bytes; the work is two compares and two adds per column.  The TPU
// kernel rotated the whole target row with a barrel shifter.  Here a
// record gets as many lanes as cover its row in two 16-byte words each
// (cd::lanes_for: 4 at L=128, so a warp holds 8 records), its scalars
// come in one 16-byte load, the rotation is one remainder per record,
// each lane reads its window columns as aligned 16-byte words lined up
// with __funnelshift_r (a window that wraps past the row end keeps the
// TPU kernel's rotation, cd::window16), and four bytes are compared per
// instruction (__vcmpeq4, the RY class by cd::is_ct4, the window tail
// masked by byte, counted with __popc).  The counts are sub-warp integer
// reductions, exact in any order.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
window_identity_kernel(const uint8_t* __restrict__ sym2, int32_t L,
                       int lanes, const int32_t* __restrict__ qrow,
                       const int32_t* __restrict__ trow,
                       const int4* __restrict__ scal, int64_t n,
                       int32_t* __restrict__ out) {
  const int sub = threadIdx.x & (lanes - 1);
  const int64_t r =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / lanes;
  if (r >= n) return;  // the whole group leaves together
  const unsigned gmask = cd::group_mask(lanes);

  const int4 s = __ldg(scal + r);  // (qstart, tstart, win, 0)
  const uint8_t* q = sym2 + static_cast<int64_t>(__ldg(qrow + r)) * L;
  const uint8_t* t = sym2 + static_cast<int64_t>(__ldg(trow + r)) * L;
  const int32_t shift = cd::wrap(static_cast<int64_t>(s.y) - s.x, L);
  const int32_t lo = max(s.x, 0);
  const int32_t hi = static_cast<int32_t>(
      min(static_cast<int64_t>(s.x) + s.z, static_cast<int64_t>(L)));

  int idc = 0, ryc = 0;
#pragma unroll 1
  for (int32_t j = lo + 16 * sub; j < hi; j += 16 * lanes) {
    const int nk = min(16, hi - j);
    const uint4 a = cd::bytes16(q + j, nk);
    const uint4 b = cd::window16(t, L, cd::wrap_near(j + shift, L), nk);
    const uint4 m = cd::tail_mask(nk);
    idc += cd::count_ff(make_uint4(
        __vcmpeq4(a.x, b.x) & m.x, __vcmpeq4(a.y, b.y) & m.y,
        __vcmpeq4(a.z, b.z) & m.z, __vcmpeq4(a.w, b.w) & m.w));
    ryc += cd::count_ff(make_uint4(
        ~(cd::is_ct4(a.x) ^ cd::is_ct4(b.x)) & m.x,
        ~(cd::is_ct4(a.y) ^ cd::is_ct4(b.y)) & m.y,
        ~(cd::is_ct4(a.z) ^ cd::is_ct4(b.z)) & m.z,
        ~(cd::is_ct4(a.w) ^ cd::is_ct4(b.w)) & m.w));
  }
  idc = __reduce_add_sync(gmask, idc);
  ryc = __reduce_add_sync(gmask, ryc);
  if (sub == 0) reinterpret_cast<int2*>(out)[r] = make_int2(idc, ryc);
}

}  // namespace

CD_EXPORT int cd_window_identity(const void* sym2, int64_t L,
                                 const void* qrow, const void* trow,
                                 const void* scal, int64_t n, void* out,
                                 void* stream) {
  if (n > 0) {
    const int lanes = cd::lanes_for(L);
    const int64_t blocks = (n * lanes + kThreads - 1) / kThreads;
    window_identity_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(sym2), static_cast<int32_t>(L), lanes,
        static_cast<const int32_t*>(qrow), static_cast<const int32_t*>(trow),
        static_cast<const int4*>(scal), n, static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
