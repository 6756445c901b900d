// Ungapped end-to-end overlap rescoring, one group of lanes per (query,
// target, diagonal) pair, comparing 16 plane bytes per lane and step.
//
// Replaces carpedeam_tpu/ops/rescore_pallas.py::_rescore_kernel (:80),
// launched there by rescore_pairs_pallas (:155).  Same contract: both
// diagonal candidates (d - 65536 and d, unsigned-short semantics) are
// scored as max(2m - 3(L - m), 0) with a match needing equal codes < 4;
// the positive candidate wins only when strictly better; the symbol
// identity count runs over the winning window (a -1 start, no hit, reads
// position 0 only).  Any window index at L or beyond wraps to the row
// start.  One int32 per pair: score in bits 0-15, id_cnt in bits 16-30,
// use_pos in the sign bit.
//
// Bound on the H100: bytes, and at the read-phase shape the latency of
// the dependent gathers (pair -> lengths -> rows).  Each pair reads the
// windows of its two plane rows (code, and symbol for the identity) and
// writes 4 bytes; the arithmetic is one compare and one add per byte.
// The TPU kernel rotated whole rows with a log2(L) barrel shifter.  Here
// each lane loads aligned 16-byte words of both rows, lines the shifted
// window up with __funnelshift_r, and compares four codes per instruction
// (__vcmpeq4, the code < 4 gate by __vcmpltu4, the row tail masked,
// counted with __popc).  The symbol identity of both candidates' windows
// is counted in the same pass (the winner's window starts where its
// candidate's does), so a pair makes one round of window loads, not two.
// A pair gets as many lanes as cover its level's row in two words each
// (4 at L=128, so a warp holds 8 pairs; a whole warp, stepping, at
// L >= 1024), and the counts are sub-warp integer reductions, exact in
// any order.  Every index is a 32-bit conditional wrap; the only
// remainders are two per pair.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Code matches (equal codes < 4) and symbol matches of the window pair
// a[(ao + j) mod L], b[(bo + j) mod L], j < n, for 16 columns from j:
// added to m (codes) and id (symbols).
__device__ __forceinline__ void window_step(
    const uint8_t* __restrict__ ac, const uint8_t* __restrict__ bc,
    const uint8_t* __restrict__ as, const uint8_t* __restrict__ bs,
    int32_t ao, int32_t bo, int32_t j, int32_t n, int32_t L, int& m,
    int& id) {
  if (j >= n) return;
  const int nk = min(16, n - j);
  const int32_t ca = cd::wrap_near(ao + j, L), cb = cd::wrap_near(bo + j, L);
  const uint4 x = cd::window16(ac, L, ca, nk);
  const uint4 y = cd::window16(bc, L, cb, nk);
  const uint4 xs = cd::window16(as, L, ca, nk);
  const uint4 ys = cd::window16(bs, L, cb, nk);
  const uint4 t = cd::tail_mask(nk);
  const uint32_t k4 = 0x04040404u;
  m += cd::count_ff(make_uint4(
      __vcmpeq4(x.x, y.x) & __vcmpltu4(x.x, k4) & t.x,
      __vcmpeq4(x.y, y.y) & __vcmpltu4(x.y, k4) & t.y,
      __vcmpeq4(x.z, y.z) & __vcmpltu4(x.z, k4) & t.z,
      __vcmpeq4(x.w, y.w) & __vcmpltu4(x.w, k4) & t.w));
  id += cd::count_ff(make_uint4(__vcmpeq4(xs.x, ys.x) & t.x,
                                __vcmpeq4(xs.y, ys.y) & t.y,
                                __vcmpeq4(xs.z, ys.z) & t.z,
                                __vcmpeq4(xs.w, ys.w) & t.w));
}

// six resident blocks an SM (40 registers a thread): more pairs in flight
// to hide the gathers than the unbounded build's 77 registers allow
__global__ void __launch_bounds__(kThreads, 6)
rescore_pairs_kernel(const uint8_t* __restrict__ code2,
                     const uint8_t* __restrict__ sym2,
                     const int32_t* __restrict__ lengths,
                     const int32_t* __restrict__ pairs, int64_t n_pairs,
                     int64_t n_seqs, int32_t L, int lanes,
                     int32_t* __restrict__ out) {
  const int sub = threadIdx.x & (lanes - 1);
  const int64_t p =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / lanes;
  if (p >= n_pairs) return;  // the whole group leaves together
  const unsigned gmask = cd::group_mask(lanes);

  const int32_t qp = pairs[3 * p];
  const int32_t tidx = pairs[3 * p + 1];
  const int32_t diag_u = pairs[3 * p + 2] & 0xFFFF;
  const int32_t qidx = qp & 0x7FFFFFFF;
  const int64_t qrow = qidx + (qp < 0 ? n_seqs : 0);
  const int32_t qlen = lengths[qidx];
  const int32_t tlen = lengths[tidx];
  const uint8_t* qc = code2 + qrow * L;
  const uint8_t* tc = code2 + static_cast<int64_t>(tidx) * L;
  const uint8_t* qs = sym2 + qrow * L;
  const uint8_t* ts = sym2 + static_cast<int64_t>(tidx) * L;
  // a pair without a hit (score 0) reads position 0 of both symbol rows
  const int id0 = qs[0] == ts[0];

  // negative candidate: q starts at 0, t starts at dist
  const int32_t dist_neg = 65536 - diag_u;
  const bool valid_neg = dist_neg < tlen;
  const int32_t len_neg = valid_neg ? min(tlen - dist_neg, qlen) : 0;
  const int32_t sh_neg = valid_neg ? dist_neg % L : 0;
  const int32_t n_neg = min(len_neg, L);
  // positive candidate: q starts at dist, t starts at 0
  const int32_t dist_pos = diag_u;
  const bool valid_pos = dist_pos < qlen;
  const int32_t len_pos = valid_pos ? min(tlen, qlen - dist_pos) : 0;
  const int32_t sh_pos = valid_pos ? dist_pos % L : 0;
  const int32_t n_pos = min(len_pos, L);

  // one pass over both candidates' windows: code matches, and the symbol
  // identity of each window (the winner's is the alignment's identity:
  // its window starts where the candidate's does)
  int m_neg = 0, m_pos = 0, id_neg = 0, id_pos = 0;
#pragma unroll 1
  for (int32_t j = 16 * sub; j < max(n_neg, n_pos); j += 16 * lanes) {
    window_step(qc, tc, qs, ts, 0, sh_neg, j, n_neg, L, m_neg, id_neg);
    window_step(qc, tc, qs, ts, sh_pos, 0, j, n_pos, L, m_pos, id_pos);
  }
  m_neg = __reduce_add_sync(gmask, m_neg);
  m_pos = __reduce_add_sync(gmask, m_pos);
  id_neg = __reduce_add_sync(gmask, id_neg);
  id_pos = __reduce_add_sync(gmask, id_pos);
  const int32_t s_neg =
      valid_neg ? max(2 * m_neg - 3 * (len_neg - m_neg), 0) : 0;
  const int32_t s_pos =
      valid_pos ? max(2 * m_pos - 3 * (len_pos - m_pos), 0) : 0;

  // the winner: the positive candidate only when strictly better
  const bool use_pos = s_pos > s_neg;
  const int32_t best_score = use_pos ? s_pos : s_neg;
  const int id = best_score == 0 ? id0 : (use_pos ? id_pos : id_neg);
  if (sub == 0) {
    uint32_t packed = static_cast<uint32_t>(best_score) +
                      (static_cast<uint32_t>(id) << 16);
    if (use_pos) packed |= 0x80000000u;
    out[p] = static_cast<int32_t>(packed);
  }
}

}  // namespace

CD_EXPORT int cd_rescore_pairs(const void* code2, const void* sym2,
                               const void* lengths, const void* pairs,
                               int64_t n_pairs, int64_t n_seqs, int64_t L,
                               void* out, void* stream) {
  if (n_pairs > 0) {
    const int lanes = cd::lanes_for(L);
    const int64_t blocks = (n_pairs * lanes + kThreads - 1) / kThreads;
    rescore_pairs_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(code2), static_cast<const uint8_t*>(sym2),
        static_cast<const int32_t*>(lengths),
        static_cast<const int32_t*>(pairs), n_pairs, n_seqs,
        static_cast<int32_t>(L), lanes, static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

CD_EXPORT const char* cd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
