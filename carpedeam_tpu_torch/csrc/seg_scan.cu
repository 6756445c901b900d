// Segmented suffix scans of the k-mer pair lookahead, in one pass: a
// block scan per tile with the carry of the later tiles found by
// decoupled look-back.
//
// Replaces carpedeam_tpu/ops/kmer_tpu.py::_tiled_suffix_scan (:404) in its
// two uses by _pair_scan (:474): the segmented suffix lexicographic max
// of (s, j) of _seg_suffix_argmax (:454), and the segmented suffix OR of
// the centre blocks (:537).  out_i = x_i (+) x_{i+1} (+) ... within the
// segment that ends at the next set flag, with combine(later, current) as
// the JAX program writes it.  The plain version is
// ops/kmer_device.py::tiled_suffix_scan_reference.
//
// Bound on the H100: bytes (17 in and 16 out an element for the argmax,
// 2 in and 1 out for the OR).  The TPU program needed two small lax.scan
// loops of sqrt(M) steps each, because an associative scan's graph did not
// compile at these sizes.  Here tiles of 4096 elements are handed out
// last first by a ticket counter; a block loads its tile (16 consecutive
// elements a thread), folds each thread's items, scans the thread
// aggregates with warp shuffles and one pass over the warps, publishes
// its tile aggregate, and its first thread walks back over the later
// tiles' published aggregates until one has published its inclusive
// value (a tile waits only on tiles handed out before it, so the walk
// cannot deadlock).  Every combine is exact integer or boolean logic, so
// the order of the tree gives the plain version's bits.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;   // ops/kmer_device.SEG_SCAN_TILE
constexpr int kWarps = kThreads / 32;

// (s, j, flag): the lexicographic max of (s, j), reset at a flag.  A
// status word packs s + 2^30 (32 bits), j + 1 (31 bits) and the flag.
struct ArgMax {
  int64_t s, j;
  bool f;
  static __device__ ArgMax identity() { return {-(1ll << 30), -1, false}; }
  static __device__ ArgMax combine(const ArgMax& a, const ArgMax& b) {
    const bool take_b = b.f || b.s > a.s || (b.s == a.s && b.j > a.j);
    return {take_b ? b.s : a.s, take_b ? b.j : a.j, a.f || b.f};
  }
  static __device__ ArgMax load(const void* s, const void* j,
                                const bool* f, int64_t i) {
    return {static_cast<const int64_t*>(s)[i],
            static_cast<const int64_t*>(j)[i], f[i]};
  }
  __device__ void store(void* s, void* j, int64_t i) const {
    static_cast<int64_t*>(s)[i] = this->s;
    static_cast<int64_t*>(j)[i] = this->j;
  }
  static __device__ ArgMax shfl_down(const ArgMax& x, int d) {
    return {__shfl_down_sync(cd::kFullMask, x.s, d),
            __shfl_down_sync(cd::kFullMask, x.j, d),
            __shfl_down_sync(cd::kFullMask, static_cast<int>(x.f), d) != 0};
  }
  __device__ uint64_t pack() const {
    return (static_cast<uint64_t>(static_cast<uint32_t>(s + (1ll << 30)))
            << 32) |
           (static_cast<uint64_t>(j + 1) << 1) | static_cast<uint64_t>(f);
  }
  static __device__ ArgMax unpack(uint64_t w) {
    return {static_cast<int64_t>(w >> 32) - (1ll << 30),
            static_cast<int64_t>((w >> 1) & 0x7fffffffull) - 1,
            (w & 1ull) != 0};
  }
};

// (v, flag): OR of v, reset at a flag.
struct Or {
  bool v, f;
  static __device__ Or identity() { return {false, false}; }
  static __device__ Or combine(const Or& a, const Or& b) {
    return {b.v || (a.v && !b.f), a.f || b.f};
  }
  static __device__ Or load(const void* s, const void*, const bool* f,
                            int64_t i) {
    return {static_cast<const bool*>(s)[i], f[i]};
  }
  __device__ void store(void* s, void*, int64_t i) const {
    static_cast<bool*>(s)[i] = v;
  }
  static __device__ Or shfl_down(const Or& x, int d) {
    const int w = __shfl_down_sync(cd::kFullMask,
                                   static_cast<int>(x.v) | (x.f << 1), d);
    return {(w & 1) != 0, (w & 2) != 0};
  }
  __device__ uint64_t pack() const {
    return static_cast<uint64_t>(v) | (static_cast<uint64_t>(f) << 1);
  }
  static __device__ Or unpack(uint64_t w) {
    return {(w & 1ull) != 0, (w & 2ull) != 0};
  }
};

// Tile states in `work`: work[0] the ticket counter, then per tile three
// words: status (0 nothing yet, 1 aggregate, 2 inclusive), the packed
// aggregate, the packed inclusive value.
template <class Op>
__global__ void __launch_bounds__(kThreads)
seg_scan_kernel(const void* __restrict__ s_in, const void* __restrict__ j_in,
                const bool* __restrict__ f_in, int64_t M, int64_t ntiles,
                void* __restrict__ s_out, void* __restrict__ j_out,
                unsigned long long* work) {
  __shared__ int64_t tile_sh;
  __shared__ Op warp_carry[kWarps];
  __shared__ Op tile_carry;
  if (threadIdx.x == 0)
    tile_sh = ntiles - 1 - static_cast<int64_t>(atomicAdd(work, 1ull));
  __syncthreads();
  const int64_t tile = tile_sh;
  const int64_t base = tile * kTile + static_cast<int64_t>(threadIdx.x) *
                                          kItems;
  Op x[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int64_t i = base + it;
    x[it] = i < M ? Op::load(s_in, j_in, f_in, i) : Op::identity();
  }
  Op agg = Op::identity();
#pragma unroll
  for (int it = kItems - 1; it >= 0; --it) agg = Op::combine(agg, x[it]);

  // inclusive suffix scan of the thread aggregates within the warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Op incl = agg;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Op other = Op::shfl_down(incl, d);
    if (lane + d < 32) incl = Op::combine(other, incl);
  }
  Op lane_carry = Op::shfl_down(incl, 1);
  if (lane == 31) lane_carry = Op::identity();
  if (lane == 0) warp_carry[warp] = incl;
  __syncthreads();

  if (threadIdx.x == 0) {
    Op run = Op::identity();
    for (int w = kWarps - 1; w >= 0; --w) {
      const Op a = warp_carry[w];
      warp_carry[w] = run;
      run = Op::combine(run, a);
    }
    // run is the tile's aggregate; look back over the later tiles
    volatile unsigned long long* st = work + 1 + 3 * tile;
    Op later = Op::identity();
    if (tile + 1 < ntiles) {
      st[1] = run.pack();
      __threadfence();
      st[0] = 1ull;
      for (int64_t t = tile + 1;; ++t) {
        volatile unsigned long long* ts = work + 1 + 3 * t;
        unsigned long long flag;
        do {
          flag = ts[0];
        } while (flag == 0ull);
        __threadfence();
        const Op v = Op::unpack(flag == 2ull ? ts[2] : ts[1]);
        later = Op::combine(v, later);
        if (flag == 2ull) break;
      }
    }
    st[2] = Op::combine(later, run).pack();
    __threadfence();
    st[0] = 2ull;
    tile_carry = later;
  }
  __syncthreads();

  Op acc = Op::combine(Op::combine(tile_carry, warp_carry[warp]),
                       lane_carry);
#pragma unroll
  for (int it = kItems - 1; it >= 0; --it) {
    acc = Op::combine(acc, x[it]);
    const int64_t i = base + it;
    if (i < M) acc.store(s_out, j_out, i);
  }
}

}  // namespace

// mode 0: argmax over (s int64, j int64, f bool) -> (s, j); s and j in
// [0, 2^31); mode 1: OR over (v bool, f bool) -> v (j_in, j_out unused).
CD_EXPORT int cd_seg_suffix_scan(int64_t mode, const void* s_in,
                                 const void* j_in, const void* f_in,
                                 int64_t M, void* s_out, void* j_out,
                                 void* work, void* stream) {
  if (M < 0 || M >= (1ll << 31) || (mode != 0 && mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M > 0) {
    const int64_t ntiles = (M + kTile - 1) / kTile;
    auto* w = static_cast<unsigned long long*>(work);
    const auto* f = static_cast<const bool*>(f_in);
    auto st = static_cast<cudaStream_t>(stream);
    if (mode == 0)
      seg_scan_kernel<ArgMax><<<static_cast<unsigned>(ntiles), kThreads, 0,
                                st>>>(s_in, j_in, f, M, ntiles, s_out, j_out,
                                      w);
    else
      seg_scan_kernel<Or><<<static_cast<unsigned>(ntiles), kThreads, 0,
                            st>>>(s_in, j_in, f, M, ntiles, s_out, j_out, w);
  }
  return static_cast<int>(cudaGetLastError());
}
