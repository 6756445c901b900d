// Ungapped end-to-end overlap rescoring, one warp per (query, target,
// diagonal) pair.
//
// Replaces carpedeam_tpu/ops/rescore_pallas.py::_rescore_kernel (:80),
// launched there by rescore_pairs_pallas (:155).  Same contract: both
// diagonal candidates (d - 65536 and d, unsigned-short semantics) are
// scored as max(2m - 3(L - m), 0) with a match needing equal codes < 4;
// the positive candidate wins only when strictly better; the symbol
// identity count runs over the winning window.  One int32 per pair:
// score in bits 0-15, id_cnt in bits 16-30, use_pos in the sign bit.
//
// Bound on the H100: bytes.  Each pair reads at most three windows of
// its two plane rows (code twice, symbol once) and writes 4 bytes; the
// arithmetic is one compare and one add per byte.  The TPU kernel
// rotated whole rows with a log2(L) barrel shifter because the VPU has
// no gather; here each lane loads its window byte directly
// (row + (j + shift) mod L), consecutive lanes read consecutive bytes,
// and the counts are integer warp reductions, so the result is exact and
// independent of the reduction order.  The planes' row gather stays
// inside the kernel: no (P, L) copies are materialised.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
rescore_pairs_kernel(const uint8_t* __restrict__ code2,
                     const uint8_t* __restrict__ sym2,
                     const int32_t* __restrict__ lengths,
                     const int32_t* __restrict__ pairs, int64_t n_pairs,
                     int64_t n_seqs, int32_t L, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t p =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (p >= n_pairs) return;  // the whole warp leaves together

  const int32_t qp = pairs[3 * p];
  const int32_t tidx = pairs[3 * p + 1];
  const int32_t diag_u = pairs[3 * p + 2] & 0xFFFF;
  const int32_t qidx = qp & 0x7FFFFFFF;
  const int64_t qrow = qidx + (qp < 0 ? n_seqs : 0);
  const int32_t qlen = lengths[qidx];
  const int32_t tlen = lengths[tidx];
  const uint8_t* qc = code2 + qrow * L;
  const uint8_t* tc = code2 + static_cast<int64_t>(tidx) * L;

  // negative candidate: q starts at 0, t starts at dist
  const int32_t dist_neg = 65536 - diag_u;
  const bool valid_neg = dist_neg < tlen;
  const int32_t len_neg = valid_neg ? min(tlen - dist_neg, qlen) : 0;
  const int32_t sh_neg = valid_neg ? dist_neg : 0;
  int m = 0;
  for (int32_t j = lane; j < len_neg && j < L; j += 32) {
    const int a = qc[j];
    const int b = tc[cd::wrap(j + sh_neg, L)];
    m += (a == b) & (a < 4);
  }
  m = __reduce_add_sync(cd::kFullMask, m);
  const int32_t s_neg = valid_neg ? max(2 * m - 3 * (len_neg - m), 0) : 0;

  // positive candidate: q starts at dist, t starts at 0
  const int32_t dist_pos = diag_u;
  const bool valid_pos = dist_pos < qlen;
  const int32_t len_pos = valid_pos ? min(tlen, qlen - dist_pos) : 0;
  const int32_t sh_pos = valid_pos ? dist_pos : 0;
  m = 0;
  for (int32_t j = lane; j < len_pos && j < L; j += 32) {
    const int a = qc[cd::wrap(j + sh_pos, L)];
    const int b = tc[j];
    m += (a == b) & (a < 4);
  }
  m = __reduce_add_sync(cd::kFullMask, m);
  const int32_t s_pos = valid_pos ? max(2 * m - 3 * (len_pos - m), 0) : 0;

  const bool use_pos = s_pos > s_neg;
  const int32_t best_score = use_pos ? s_pos : s_neg;
  const int32_t best_len = use_pos ? len_pos : len_neg;
  const int32_t best_dist = use_pos ? dist_pos : dist_neg;
  const bool got = best_score > 0;
  const int32_t start = got ? 0 : -1;
  const int32_t end = got ? best_len - 1 : -1;
  const int32_t dist = got ? best_dist : 0;
  const bool dneg = got && !use_pos;
  const int32_t qstart = dneg ? start : start + dist;
  const int32_t tstart = dneg ? start + dist : start;
  const int32_t aln_len = end - start + 1;

  // identity over the winning window; a -1 start reads position 0 only
  // (aln_len is 1 there), as the TPU kernel's clipped rotation does
  const int32_t sh_q = max(qstart, 0);
  const int32_t sh_t = max(tstart, 0);
  const int32_t q_off = sh_q > 0 ? sh_q + sh_t : 0;
  const int32_t t_off = sh_q > 0 ? 0 : sh_q + sh_t;
  const uint8_t* qs = sym2 + qrow * L;
  const uint8_t* ts = sym2 + static_cast<int64_t>(tidx) * L;
  int id = 0;
  for (int32_t j = lane; j < aln_len && j < L; j += 32) {
    id += qs[cd::wrap(j + q_off, L)] == ts[cd::wrap(j + t_off, L)];
  }
  id = __reduce_add_sync(cd::kFullMask, id);
  if (lane == 0) {
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
    const int64_t blocks = (n_pairs + kWarpsPerBlock - 1) / kWarpsPerBlock;
    rescore_pairs_kernel<<<static_cast<unsigned>(blocks), 32 * kWarpsPerBlock,
                           0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(code2), static_cast<const uint8_t*>(sym2),
        static_cast<const int32_t*>(lengths),
        static_cast<const int32_t*>(pairs), n_pairs, n_seqs,
        static_cast<int32_t>(L), static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

CD_EXPORT const char* cd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
