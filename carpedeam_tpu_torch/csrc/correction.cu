// Fused Bayesian per-base correction, one block per four query slots.
//
// Replaces carpedeam_tpu/ops/correction_pallas.py::_correction_kernel_body
// (:99), both its variants (chunked=False for L <= 2048, chunked=True for
// 4096-8192), launched there by _correction_pallas_device (:258).
//
// Input layout (as the TPU kernel's, with the row gathers moved inside):
// query blocks of G slots and R record slots; record i of block b has
// plane row rec_rows[b*R+i] and scalars rscal[b*R+i] = (qstart, tstart,
// alen, tlen, ry_smin, use, slot, is_rev); slot s of block b has plane
// row slot_qid[b*G+s] and scalars qscal[b*G+s] = (qlen, was_ext, ...).
// Output byte (b*G/4 + g, p) packs the 2-bit bases of slots g, g+G/4,
// g+2G/4 and g+3G/4 at position p; CUDA block (b, g) owns that byte row.
//
// Per slot and position the kernel counts, for the 44 classes
// targetBase*11 + damageLayer, the records of the slot whose aligned,
// RY-gated column falls in the class (all records, and reverse records
// only), then sums the f32 log-likelihood for the four candidate bases
// in the TPU kernel's order (class t*11+l ascending; per class
// (lik + F*w_fwd) + R*w_rev with F = all - rev), adds the prior
// tot*log_q, and takes the first maximum; the position keeps its base
// when C->T or G->A coverage reaches 0.4 or total coverage is below 2.
//
// Bound on the H100: bytes (and latency at small grids).  The TPU kernel
// built the 44-class histogram as a one-hot bf16 MXU product; here each
// thread owns one position of a 128-position chunk and counts into its
// own column of a shared-memory table (88 x 128 uint16), so the counts
// are integers with no atomics and no order dependence.  The f32 sum is
// serial per thread with __fmul_rn/__fadd_rn (never contracted to FMA),
// reproducing the plain version's rounding exactly.  Long levels
// (L > 2048, the TPU's chunked variant) are the same loop over more
// position chunks.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;    // positions per chunk
constexpr int kMaxRecords = 512; // largest record tile (R) accepted
constexpr int kClasses = 44;

__global__ void __launch_bounds__(kThreads)
correction_kernel(const uint8_t* __restrict__ sym2, int32_t L,
                  const int32_t* __restrict__ rec_rows,
                  const int32_t* __restrict__ rscal,
                  const int32_t* __restrict__ slot_qid,
                  const int32_t* __restrict__ qscal,
                  const float* __restrict__ wtab, int32_t G, int32_t R,
                  uint8_t* __restrict__ out) {
  __shared__ uint16_t hist[2 * kClasses][kThreads];
  __shared__ float w[48 * 16];
  __shared__ uint8_t keep[kMaxRecords];
  __shared__ int rlo[4], rhi[4];

  const int Q = G / 4;
  const int b = blockIdx.x / Q;
  const int g = blockIdx.x % Q;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = kThreads / 32;

  for (int i = tid; i < 48 * 16; i += kThreads) w[i] = wtab[i];
  if (tid < 4) {
    rlo[tid] = R;
    rhi[tid] = -1;
  }
  __syncthreads();

  // ---- phase 1: RY gate of every record of this block's four slots ----
  for (int i = warp; i < R; i += nwarps) {
    const int32_t* rs = rscal + (static_cast<int64_t>(b) * R + i) * 8;
    const int32_t slot = rs[6];
    const bool mine = slot < G && slot % Q == g;
    if (!mine) {
      if (lane == 0) keep[i] = 0;
      continue;
    }
    const int32_t qstart = rs[0], tstart = rs[1], alen = rs[2];
    const int32_t smin = rs[4], keep_pre = rs[5];
    const uint8_t* qrow =
        sym2 + static_cast<int64_t>(slot_qid[b * G + slot]) * L;
    const uint8_t* trow =
        sym2 + static_cast<int64_t>(rec_rows[static_cast<int64_t>(b) * R + i]) * L;
    const int32_t shift = cd::wrap(static_cast<int64_t>(tstart) - qstart, L);
    int ry = 0;
    const int32_t hi = min(qstart + alen, L);
    for (int32_t p = max(qstart, 0) + lane; p < hi; p += 32) {
      ry += cd::is_ct(qrow[p]) ==
            cd::is_ct(trow[cd::wrap(static_cast<int64_t>(p) + shift, L)]);
    }
    ry = __reduce_add_sync(cd::kFullMask, ry);
    if (lane == 0) {
      keep[i] = (keep_pre != 0) && (ry >= smin);
      const int j = slot / Q;
      atomicMin(&rlo[j], i);
      atomicMax(&rhi[j], i);
    }
  }
  __syncthreads();

  // ---- phase 2: per position, class counts -> likelihood -> base -----
  for (int32_t p0 = 0; p0 < L; p0 += kThreads) {
    const int32_t p = p0 + tid;
    if (p >= L) break;  // no barrier below: threads work on own columns
    uint32_t packed = 0;
    for (int j = 0; j < 4; ++j) {
      const int slot = g + j * Q;
      for (int c = 0; c < 2 * kClasses; ++c) hist[c][tid] = 0;
      for (int i = rlo[j]; i <= rhi[j]; ++i) {
        if (!keep[i]) continue;
        const int32_t* rs = rscal + (static_cast<int64_t>(b) * R + i) * 8;
        if (rs[6] != slot) continue;
        const int32_t qstart = rs[0], tstart = rs[1], alen = rs[2];
        if (p < qstart || p >= qstart + alen) continue;
        const int32_t tlen = rs[3];
        const uint8_t* trow =
            sym2 +
            static_cast<int64_t>(rec_rows[static_cast<int64_t>(b) * R + i]) * L;
        const int32_t shift =
            cd::wrap(static_cast<int64_t>(tstart) - qstart, L);
        const int tb =
            cd::acgt_code(trow[cd::wrap(static_cast<int64_t>(p) + shift, L)]);
        const int32_t t_real = tstart + p - qstart;
        int layer = t_real < 5 ? t_real : 5;
        if (t_real - (tlen - 5) >= 0) layer = 6 + t_real - (tlen - 5);
        const int c = tb * 11 + layer;
        if (c >= kClasses) continue;  // no class, as in the TPU kernel
        hist[c][tid] += 1;
        if (rs[7] != 0) hist[kClasses + c][tid] += 1;
      }

      float lik[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      int cov[4];
      for (int t = 0; t < 4; ++t) {
        int cov_t = 0;
        for (int l = 0; l < 11; ++l) {
          const int c = t * 11 + l;
          const int cc = hist[c][tid];
          const int rc = hist[kClasses + c][tid];
          cov_t += cc;
          const float f = static_cast<float>(cc - rc);
          const float rf = static_cast<float>(rc);
          for (int q = 0; q < 4; ++q) {
            lik[q] = __fadd_rn(__fadd_rn(lik[q], __fmul_rn(f, w[c * 16 + q])),
                               __fmul_rn(rf, w[c * 16 + 4 + q]));
          }
        }
        cov[t] = cov_t;
      }
      const int tot = cov[0] + cov[1] + cov[2] + cov[3];

      const int32_t* qs = qscal + (static_cast<int64_t>(b) * G + slot) * 8;
      const int32_t qlen = qs[0];
      const bool was_ext = qs[1] != 0;
      const int obs = cd::acgt_code(
          sym2[static_cast<int64_t>(slot_qid[b * G + slot]) * L + p]);
      int own = p < 5 ? p : 5;
      if (p - (qlen - 5) >= 0) own = 6 + p - (qlen - 5);
      const float tot_f = static_cast<float>(tot);
      for (int q = 0; q < 4; ++q) {
        float log_q;
        if (was_ext) {
          log_q = w[(44 + obs) * 16 + q];
        } else {
          log_q = own <= 10 ? w[(obs * 11 + own) * 16 + q] : 0.0f;
        }
        lik[q] = __fadd_rn(lik[q], __fmul_rn(tot_f, log_q));
      }
      float best = lik[0];
      int bi = 0;
      for (int q = 1; q < 4; ++q) {
        if (lik[q] > best) {
          best = lik[q];
          bi = q;
        }
      }
      const bool ratio_exit =
          !was_ext && (5 * cov[3] >= 2 * tot || 5 * cov[0] >= 2 * tot);
      const int fin = (ratio_exit || tot < 2) ? obs : bi;
      packed |= static_cast<uint32_t>(fin) << (2 * j);
    }
    out[(static_cast<int64_t>(b) * Q + g) * L + p] =
        static_cast<uint8_t>(packed);
  }
}

}  // namespace

CD_EXPORT int cd_correction(const void* sym2, int64_t L, const void* rec_rows,
                            const void* rscal, const void* slot_qid,
                            const void* qscal, const void* wtab, int64_t nb,
                            int64_t G, int64_t R, void* out, void* stream) {
  if (G % 4 != 0 || R > kMaxRecords) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb > 0) {
    const int64_t blocks = nb * (G / 4);
    correction_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(sym2), static_cast<int32_t>(L),
        static_cast<const int32_t*>(rec_rows),
        static_cast<const int32_t*>(rscal),
        static_cast<const int32_t*>(slot_qid),
        static_cast<const int32_t*>(qscal), static_cast<const float*>(wtab),
        static_cast<int32_t>(G), static_cast<int32_t>(R),
        static_cast<uint8_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
