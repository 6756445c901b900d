// The k-mer subsampling walk, one thread per sequence row.
//
// Replaces carpedeam_tpu/ops/kmer_tpu.py::_select_bucket (:190), itself
// the walk of the reference's kmermatcher.cpp:226-350 over each row's
// windows sorted by (h16, k-mer, position): a lax.scan state machine over
// the columns there; the plain version is
// ops/kmer_device.py::select_bucket_reference.  Per row:
//   considered = min(int(f32(kps - 1) + f32(scale) * f32(len)), valid)
//   threshold  = h16[considered - 1] + 1, too_much = rank(threshold) -
//                considered (the reference's 65536-bin histogram collapses
//                to these two numbers);
// then the cursor walk: a run of equal k-mers met at the cursor is
// skipped and the next different window processed unconditionally; a
// processed window below the threshold is a hit, and the last too_much
// hits at threshold - 1 lower the threshold.
//
// Bound on the H100: the walk is sequential within a row and each step
// depends on the last, so the time is the latency of one row's chain of
// loads and compares; across rows it is bytes (8 a window in, 1 out).
// The TPU program stepped every row together, one column a scan step;
// here each thread owns a row and reads it in order: once for the valid
// count, once for the rank, and once for the walk, which stops comparing
// once `considered` windows are selected (no later window can be) and
// writes zeros for the rest of the row.  The f32 `considered` is
// computed with __fmul_rn / __fadd_rn, so no fused multiply-add changes
// its rounding.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr uint64_t kAll1 = ~0ull;       // a window that is not kept

// The window's 16-bit hash, 65536 for a window that is not kept.
__device__ __forceinline__ int64_t h16_of(uint64_t key, int sh) {
  return key == kAll1 ? 65536 : static_cast<int64_t>(key >> sh);
}

__global__ void __launch_bounds__(kThreads)
kmer_select_kernel(const uint64_t* __restrict__ key2s,
                   const int32_t* __restrict__ lengths, int64_t B,
                   int32_t W, int k, int32_t kps, float scale,
                   bool* __restrict__ hits) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= B) return;
  const uint64_t* row = key2s + r * W;
  bool* out = hits + r * W;
  const int sh = 2 * k;

  int32_t valid = 0;
  for (int32_t c = 0; c < W; ++c) valid += __ldg(row + c) != kAll1;
  const float cf = __fadd_rn(static_cast<float>(kps - 1),
                             __fmul_rn(scale, static_cast<float>(
                                 __ldg(lengths + r))));
  const int64_t considered = min(static_cast<int64_t>(cf),
                                 static_cast<int64_t>(valid));
  int64_t thr = 0, too_much = 0;
  if (considered > 0) {
    const int32_t gi = static_cast<int32_t>(min(considered - 1,
                                                 static_cast<int64_t>(W - 1)));
    thr = h16_of(__ldg(row + gi), sh) + 1;
    int64_t rank = 0;
    for (int32_t c = 0; c < W; ++c) rank += h16_of(__ldg(row + c), sh) < thr;
    too_much = rank - considered;
  }

  bool in_skip = false, prv = false;
  int64_t sel = 0;
  int32_t c = 0;
  uint64_t key = W > 0 ? __ldg(row) : kAll1;
  for (; c < W && sel < considered; ++c) {
    const uint64_t nkey = c + 1 < W ? __ldg(row + c + 1) : kAll1;
    const bool vld = key != kAll1;
    const bool nxt = c + 1 < W && nkey == key && nkey != kAll1;
    const int64_t h = h16_of(key, sh);
    const bool landed = in_skip && !prv;
    const bool enter_skip = !in_skip && nxt;
    const bool process = (landed || (!in_skip && !nxt)) && vld;
    const bool hit = process && h < thr;
    if (hit && h == thr - 1 && too_much != 0) {
      --too_much;
      if (too_much == 0) --thr;
    }
    sel += hit;
    in_skip = (in_skip && prv) || enter_skip;
    prv = nxt;
    out[c] = hit;
    key = nkey;
  }
  for (; c < W; ++c) out[c] = false;
}

}  // namespace

CD_EXPORT int cd_kmer_select(const void* key2s, const void* lengths,
                             int64_t B, int64_t W, int64_t k, int64_t kps,
                             float scale, void* hits, void* stream) {
  if (k < 1 || k > 31 || B < 0 || W < 0 || W > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0) {
    const int64_t blocks = (B + kThreads - 1) / kThreads;
    kmer_select_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(key2s),
        static_cast<const int32_t*>(lengths), B, static_cast<int32_t>(W),
        static_cast<int>(k), static_cast<int32_t>(kps), scale,
        static_cast<bool*>(hits));
  }
  return static_cast<int>(cudaGetLastError());
}
