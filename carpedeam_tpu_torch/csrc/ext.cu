// Safe-mode consensus window of the read-phase extension scoring, one
// group of lanes per alignment record, 16 columns per lane and step.
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
// Bound on the H100: bytes, and at the read-phase shape the latency of
// the dependent loads and of the ordered sum.  A record reads its used
// target columns and the matching query window and writes 16 bytes.
// The column range is clamped once per record to
// [max(ir0, -qpos0, 0), min(tlen, L, ir1, qlen - qpos0)), so inside it
// only 'N' is masked.  A record gets cd::lanes_for(L) lanes (4 at
// L=128), its scalars come in two 16-byte loads issued before the block
// stages the (11, 16) table in shared memory, and each lane reads 16
// columns of both rows as aligned 16-byte words (cd::bytes16, and
// cd::window16 for the query window, which keeps the TPU kernel's
// rotation past the row end).  Counts use packed byte compares
// (__vcmpeq4, 'N' masked by byte, counted with __popc) and sub-warp
// integer reductions, exact in any order.
//
// The f32 sum is taken strictly left to right, bit for bit the plain
// version's column loop: each lane looks up the table values of its 16
// columns (+0 for a column that is not used, the staged table row's 17th
// entry) and stores them in shared memory in column order; the group's
// first lane then adds the round's 16 * lanes values with __fadd_rn,
// one dependent add a column.  Columns outside [lo, hi) are not added,
// and an unused column inside adds +0, as in the plain version; neither
// changes a bit: the sum starts at +0, x + (+0) = x for every x but -0,
// and a round-to-nearest sum that starts at +0 never reaches -0.  The
// TPU kernel's lane-tree sum may differ in the last ulps, which the
// caller tolerates: every queue entrant is re-scored in 80-bit
// arithmetic on the host (ops/extension_batch.py).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kN4 = 0x4e4e4e4eu;  // 'N' in each byte

// the staged table's row: the 16 base pairs, then +0 for a column that
// is not used
constexpr int kRow = 17;

__global__ void __launch_bounds__(kThreads)
consensus_likelihood_kernel(const float* __restrict__ wtab,
                            const uint8_t* __restrict__ sym2, int32_t L,
                            int lanes, const int32_t* __restrict__ qrow,
                            const int32_t* __restrict__ trow,
                            const int4* __restrict__ scal, int64_t n,
                            float* __restrict__ out) {
  __shared__ float w[11 * kRow];
  // each lane's 16 column values (4 float4s), so each group's lie in
  // column order
  __shared__ float4 vals[kThreads * 4];
  const int sub = threadIdx.x & (lanes - 1);
  const int64_t r =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / lanes;
  // the record's loads go out before the table is staged (a padding
  // group reads the last record and leaves after the barrier)
  const int64_t rl = min(r, n - 1);
  const int4 s0 = __ldg(scal + 2 * rl);      // (qpos0, qlen, tlen, ir0)
  const int4 s1 = __ldg(scal + 2 * rl + 1);  // (ir1, 0, 0, 0)
  const int32_t qi = __ldg(qrow + rl), ti = __ldg(trow + rl);
  for (int i = threadIdx.x; i < 11 * kRow; i += blockDim.x) {
    const int c = i % kRow;
    w[i] = c < 16 ? wtab[(i / kRow) * 16 + c] : 0.0f;
  }
  __syncthreads();
  if (r >= n) return;  // the whole group leaves together
  const unsigned gmask = cd::group_mask(lanes);

  const uint8_t* q = sym2 + static_cast<int64_t>(qi) * L;
  const uint8_t* t = sym2 + static_cast<int64_t>(ti) * L;
  const int32_t qpos0 = s0.x, tlen = s0.z;
  // the used columns lie in [lo, hi) (64-bit: any int32 scalars)
  const int64_t lo64 =
      max(max(static_cast<int64_t>(s0.w), -static_cast<int64_t>(qpos0)),
          int64_t{0});
  const int64_t hi64 =
      min(min(static_cast<int64_t>(min(tlen, L)),
              static_cast<int64_t>(s1.x)),
          static_cast<int64_t>(s0.y) - qpos0);
  const int32_t lo = static_cast<int32_t>(min(lo64, int64_t{L}));
  const int32_t hi = static_cast<int32_t>(max(hi64, int64_t{lo}));
  const int32_t qoff = cd::wrap(qpos0, L);
  float4* group = vals + 4 * (threadIdx.x - sub);

  int total = 0, idc = 0, ryc = 0;
  float lik = 0.0f;
#pragma unroll 1
  for (int32_t base = lo; base < hi; base += 16 * lanes) {
    const int32_t j = base + 16 * sub;
    const int nk = min(16, hi - j);  // <= 0: no column of this lane
    if (nk > 0) {
      const uint4 a = cd::window16(q, L, cd::wrap_near(j + qoff, L), nk);
      const uint4 b = cd::bytes16(t + j, nk);
      const uint4 m = cd::tail_mask(nk);
      const uint32_t aw[4] = {a.x, a.y, a.z, a.w};
      const uint32_t bw[4] = {b.x, b.y, b.z, b.w};
      const uint32_t mw[4] = {m.x, m.y, m.z, m.w};
      // the layer is 5 unless the 16 columns touch the first five or
      // the last five target columns
      const bool ends = j < 5 || j + 16 > tlen - 5;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t use =
            mw[k] & ~__vcmpeq4(aw[k], kN4) & ~__vcmpeq4(bw[k], kN4);
        total += __popc(use) >> 3;
        idc += __popc(__vcmpeq4(aw[k], bw[k]) & use) >> 3;
        const uint32_t same_ry = ~(cd::is_ct4(aw[k]) ^ cd::is_ct4(bw[k]));
        ryc += __popc(same_ry & use) >> 3;
        // per byte, the table column: 4 * qbase + tbase where the column
        // is used, else 16 (+0; see the note above)
        const uint32_t col =
            (((cd::acgt_code4(aw[k]) << 2) | cd::acgt_code4(bw[k])) & use) |
            (0x10101010u & ~use);
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int layer = 5;
          if (ends) {
            const int p = j + 4 * k + e;
            layer = p < 5 ? p : 5;
            if (p >= tlen - 5) layer = 6 + p - (tlen - 5);
            layer = min(layer, 10);  // a column past tlen is not used
          }
          v[e] = w[layer * kRow + ((col >> (8 * e)) & 0xffu)];
        }
        group[4 * sub + k] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    __syncwarp(gmask);
    // the group's first lane adds the round's columns in order
    if (sub == 0) {
      const int ncols = min(16 * lanes, hi - base);
      for (int c = 0; c < ncols; c += 4) {
        const float4 x = group[c >> 2];
        lik = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(lik, x.x), x.y), x.z),
                        x.w);
      }
    }
    __syncwarp(gmask);
  }
  total = __reduce_add_sync(gmask, total);
  idc = __reduce_add_sync(gmask, idc);
  ryc = __reduce_add_sync(gmask, ryc);
  if (sub == 0) {
    reinterpret_cast<float4*>(out)[r] =
        make_float4(static_cast<float>(total), static_cast<float>(idc),
                    static_cast<float>(ryc), lik);
  }
}

}  // namespace

CD_EXPORT int cd_consensus_likelihood(const void* wtab, const void* sym2,
                                      int64_t L, const void* qrow,
                                      const void* trow, const void* scal,
                                      int64_t n, void* out, void* stream) {
  if (n > 0) {
    const int lanes = cd::lanes_for(L);
    const int64_t blocks = (n * lanes + kThreads - 1) / kThreads;
    consensus_likelihood_kernel<<<static_cast<unsigned>(blocks), kThreads,
                                  0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(wtab), static_cast<const uint8_t*>(sym2),
        static_cast<int32_t>(L), lanes, static_cast<const int32_t*>(qrow),
        static_cast<const int32_t*>(trow), static_cast<const int4*>(scal), n,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
