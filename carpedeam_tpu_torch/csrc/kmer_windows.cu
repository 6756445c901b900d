// The k-mer windows of one length bucket, one block per sequence row:
// the row's identity hash and, for every window, its packed k-mer,
// canonical form, 16-bit xxh64 subsampling hash and strand.
//
// Replaces the two per-row programs of carpedeam_tpu/ops/kmer_tpu.py that
// open the device kmermatcher: _identity_hash (:121; Util::hash
// h = h*31 + code over the true length, a lax.scan over columns, then
// xxh64) and _windows_bucket (:138; pack k codes, N-window mask,
// canonicalise, xxh64, key2 = (h16 << 2k) | canon, pos_strand =
// (pos_f << 1) | fwd).  The plain versions are
// ops/kmer_device.py::identity_hash_reference / windows_bucket_reference.
//
// Bound on the H100: bytes (each row's codes in, 12 bytes a window and 8
// a row out); the operations, about 60 64-bit integer ops a window (the
// packing, the reverse complement and the xxh64 multiplies), are well
// under the card's integer rate.  The TPU program ran the hash as a scan
// of B-wide vector steps over the columns; here the polynomial hash is
// split into per-thread chunks (Horner within a chunk, then each chunk's
// sum times 31^(codes after it), added up in any order: arithmetic mod
// 2^64 is exact), and each thread builds whole windows from the row's
// codes staged in shared memory.  The k-mer is the same OR chain as the
// JAX program, ((kmer << 2) | code) over k codes, so windows holding a
// code 4 (X, padding) carry the same bits there too.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxK = 31;

constexpr uint64_t kP1 = 0x9E3779B185EBCA87ull;
constexpr uint64_t kP2 = 0xC2B2AE3D27D4EB4Full;
constexpr uint64_t kP3 = 0x165667B19E3779F9ull;
constexpr uint64_t kP4 = 0x85EBCA77C2B2AE63ull;
constexpr uint64_t kP5 = 0x27D4EB2F165667C5ull;

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

// XXH64 of one 8-byte word (kmer/xxh64.xxh64_u64).
__device__ __forceinline__ uint64_t xxh64_u64(uint64_t v, uint64_t seed) {
  const uint64_t k1 = rotl64(v * kP2, 31) * kP1;
  uint64_t acc = (kP5 + seed + 8ull) ^ k1;
  acc = rotl64(acc, 27) * kP1 + kP4;
  acc ^= acc >> 33;
  acc *= kP2;
  acc ^= acc >> 29;
  acc *= kP3;
  acc ^= acc >> 32;
  return acc;
}

// Packed-k-mer reverse complement (Util.cpp:601-640).
__device__ __forceinline__ uint64_t revcomp(uint64_t x, int k) {
  x ^= 0xAAAAAAAAAAAAAAAAull;
  x = ((x >> 2) & 0x3333333333333333ull) | ((x & 0x3333333333333333ull) << 2);
  x = ((x >> 4) & 0x0F0F0F0F0F0F0F0Full) | ((x & 0x0F0F0F0F0F0F0F0Full) << 4);
  x = ((x >> 8) & 0x00FF00FF00FF00FFull) | ((x & 0x00FF00FF00FF00FFull) << 8);
  x = ((x >> 16) & 0x0000FFFF0000FFFFull) |
      ((x & 0x0000FFFF0000FFFFull) << 16);
  x = (x >> 32) | (x << 32);
  return x >> (64 - 2 * k);
}

// 31^e mod 2^64.
__device__ __forceinline__ uint64_t pow31(int64_t e) {
  uint64_t r = 1, b = 31;
  while (e > 0) {
    if (e & 1) r *= b;
    b *= b;
    e >>= 1;
  }
  return r;
}

__global__ void __launch_bounds__(kThreads)
kmer_windows_kernel(const uint8_t* __restrict__ codes,
                    const int32_t* __restrict__ lengths, int32_t L, int k,
                    int32_t W, uint64_t seed, uint64_t* __restrict__ id_hash,
                    uint64_t* __restrict__ key2,
                    uint32_t* __restrict__ pos_strand) {
  __shared__ uint8_t stage[kThreads + kMaxK];
  __shared__ uint64_t part[kThreads / 32];
  const int64_t r = blockIdx.x;
  const uint8_t* row = codes + r * L;
  const int32_t len = __ldg(lengths + r);
  const int t = threadIdx.x;

  // identity hash: thread t folds columns [lo, hi) by Horner's rule and
  // weighs its sum by 31^(len - hi)
  {
    const int32_t n = min(max(len, 0), L);
    const int32_t chunk = (n + kThreads - 1) / kThreads;
    const int32_t lo = min(t * chunk, n), hi = min(lo + chunk, n);
    uint64_t h = 0;
    for (int32_t c = lo; c < hi; ++c) h = h * 31ull + __ldg(row + c);
    h *= pow31(static_cast<int64_t>(n) - hi);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      h += __shfl_down_sync(cd::kFullMask, h, off);
    if ((t & 31) == 0) part[t >> 5] = h;
    __syncthreads();
    if (t == 0) {
      uint64_t s = 0;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) s += part[w];
      id_hash[r] = xxh64_u64(s, seed);
    }
  }

  for (int32_t p0 = 0; p0 < W; p0 += kThreads) {
    __syncthreads();
    // codes p0 .. p0 + kThreads + k - 2 of the row (p0 + W - 1 + k - 1
    // <= L - 1 bounds every window; a column past the row is never read)
    for (int c = t; c < kThreads + k - 1; c += kThreads) {
      const int32_t col = p0 + c;
      stage[c] = col < L ? __ldg(row + col) : 4;
    }
    __syncthreads();
    const int32_t p = p0 + t;
    if (p >= W) continue;
    uint64_t kmer = 0;
    bool has_x = false;
    for (int j = 0; j < k; ++j) {
      const uint8_t c = stage[t + j];
      kmer = (kmer << 2) | c;
      has_x |= c > 3;
    }
    const uint64_t rc = revcomp(kmer, k);
    const bool pick_rev = rc < kmer;
    const uint64_t canon = pick_rev ? rc : kmer;
    const bool keep = !has_x && p + k <= len && rc != kmer;
    const int32_t pos_f = pick_rev ? len - p - k : p;
    const uint64_t h16 = xxh64_u64(canon, seed) & 0xFFFFull;
    const int64_t o = r * W + p;
    key2[o] = keep ? (h16 << (2 * k)) | canon : ~0ull;
    pos_strand[o] = (static_cast<uint32_t>(pos_f) << 1) |
                    static_cast<uint32_t>(!pick_rev);
  }
}

}  // namespace

CD_EXPORT int cd_kmer_windows(const void* codes, const void* lengths,
                              int64_t B, int64_t L, int64_t k,
                              int64_t seed, void* id_hash, void* key2,
                              void* pos_strand, void* stream) {
  if (k < 1 || k > kMaxK || B < 0 || L < 0 || B > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0) {
    const int64_t W = L >= k ? L - k + 1 : 0;
    kmer_windows_kernel<<<static_cast<unsigned>(B), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(codes),
        static_cast<const int32_t*>(lengths), static_cast<int32_t>(L),
        static_cast<int>(k), static_cast<int32_t>(W),
        static_cast<uint64_t>(seed), static_cast<uint64_t*>(id_hash),
        static_cast<uint64_t*>(key2), static_cast<uint32_t*>(pos_strand));
  }
  return static_cast<int>(cudaGetLastError());
}
