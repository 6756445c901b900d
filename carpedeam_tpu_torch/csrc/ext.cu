// Safe-mode consensus window of the read-phase extension scoring, one
// warp per alignment record.
//
// Replaces carpedeam_tpu/ops/ext_pallas.py::_cons_kernel (:64), launched
// there by _cons_device (:144).  Column p of the target row compares
// with query column qpos0 + p (read as q[(p + qpos0) mod L]); a column
// is used when both characters are not 'N', the query column lies in
// [0, qlen), the target column in [0, tlen) and p in [ir0, ir1).  Over
// the used columns the kernel counts total, exact identity and RY
// identity, and sums the f32 damage log-likelihood wtab[layer, 4*qb+tb]
// with layer p for p < 5, 6 + p - (tlen - 5) for the last five target
// columns (the 3' rule wins for short targets) and 5 elsewhere.
//
// Bound on the H100: bytes.  A record reads one target row prefix and
// the matching query window and writes 16 bytes.  Counts are integer
// warp reductions.  The f32 sum is taken strictly left to right over the
// columns (each lane's value is broadcast in column order and added with
// __fadd_rn), so it is deterministic and equal to the plain version's
// column loop; the TPU kernel's lane-tree sum may differ in the last
// ulps, which the caller tolerates: every queue entrant is re-scored in
// 80-bit arithmetic on the host (ops/extension_batch.py).
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
consensus_likelihood_kernel(const float* __restrict__ wtab,
                            const uint8_t* __restrict__ sym2, int32_t L,
                            const int32_t* __restrict__ qrow,
                            const int32_t* __restrict__ trow,
                            const int32_t* __restrict__ scal, int64_t n,
                            float* __restrict__ out) {
  __shared__ float w[11 * 16];
  for (int i = threadIdx.x; i < 11 * 16; i += blockDim.x) w[i] = wtab[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= n) return;
  const uint8_t* q = sym2 + static_cast<int64_t>(qrow[r]) * L;
  const uint8_t* t = sym2 + static_cast<int64_t>(trow[r]) * L;
  const int32_t qpos0 = scal[8 * r];
  const int32_t qlen = scal[8 * r + 1];
  const int32_t tlen = scal[8 * r + 2];
  const int32_t ir0 = scal[8 * r + 3];
  const int32_t ir1 = scal[8 * r + 4];
  const int32_t shift = cd::wrap(qpos0, L);
  const int32_t hi = min(tlen, L);  // columns >= tlen are never used

  int total = 0, idc = 0, ryc = 0;
  float lik = 0.0f;
  for (int32_t base = 0; base < hi; base += 32) {
    const int32_t p = base + lane;
    float v = 0.0f;
    if (p < hi) {
      const int b = t[p];
      const int a = q[cd::wrap(static_cast<int64_t>(p) + shift, L)];
      const int32_t qp = qpos0 + p;
      const bool use = b != 'N' && a != 'N' && qp >= 0 && qp < qlen &&
                       p >= ir0 && p < ir1;
      if (use) {
        total += 1;
        idc += a == b;
        ryc += cd::is_ct(a) == cd::is_ct(b);
        int layer = p < 5 ? p : 5;
        if (p >= tlen - 5) layer = 6 + p - (tlen - 5);
        v = w[layer * 16 + cd::acgt_code(a) * 4 + cd::acgt_code(b)];
      }
    }
    // column order: every lane adds the 32 values in lane order
    for (int k = 0; k < 32; ++k) {
      lik = __fadd_rn(lik, __shfl_sync(cd::kFullMask, v, k));
    }
  }
  total = __reduce_add_sync(cd::kFullMask, total);
  idc = __reduce_add_sync(cd::kFullMask, idc);
  ryc = __reduce_add_sync(cd::kFullMask, ryc);
  if (lane == 0) {
    out[4 * r] = static_cast<float>(total);
    out[4 * r + 1] = static_cast<float>(idc);
    out[4 * r + 2] = static_cast<float>(ryc);
    out[4 * r + 3] = lik;
  }
}

}  // namespace

CD_EXPORT int cd_consensus_likelihood(const void* wtab, const void* sym2,
                                      int64_t L, const void* qrow,
                                      const void* trow, const void* scal,
                                      int64_t n, void* out, void* stream) {
  if (n > 0) {
    const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    consensus_likelihood_kernel<<<static_cast<unsigned>(blocks),
                                  32 * kWarpsPerBlock, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(wtab), static_cast<const uint8_t*>(sym2),
        static_cast<int32_t>(L), static_cast<const int32_t*>(qrow),
        static_cast<const int32_t*>(trow), static_cast<const int32_t*>(scal),
        n, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
