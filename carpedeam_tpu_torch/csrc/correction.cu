// Fused Bayesian per-base correction, one block per (query block,
// 128-position tile).
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
// A record whose slot lies outside [0, G) belongs to no slot.  Output byte
// (b*G/4 + g, p) packs the 2-bit bases of slots g, g+G/4, g+2G/4 and
// g+3G/4 at position p.
//
// Per slot and position the kernel counts, for the 44 classes
// targetBase*11 + damageLayer, the kept records of the slot whose aligned
// column falls in the class (all records, and reverse records only), sums
// the f32 log-likelihood of the four candidate bases in the TPU kernel's
// order (class t*11+l ascending; per class (lik + F*w_fwd) + R*w_rev with
// F = all - rev), adds the prior tot*log_q and takes the first maximum;
// the position keeps its base when C->T or G->A coverage reaches 0.4 or
// total coverage is below 2.
//
// Bound on the H100: the bytes these inputs need take about 0.011 ms at
// the read-phase shape and the f32 sums they need less (no FMA may be
// used, since the tie rule needs the plain version's rounding, so the f32
// ceiling is half the 67 TFLOP/s peak).  What holds the kernel back is
// latency: each position walks the records near it, and every record that
// covers it costs a dependent gather of one target byte, with 16 warps a
// SM to hide it.  What the design does about that:
//   * work only where it is needed: a cell with coverage below 2, or with
//     the ratio exit, keeps its observed base without a sum; a covered
//     cell sums only its non-zero classes, walking a 44-bit presence mask
//     with __ffsll in ascending order.  Exact: a zero class adds 0*w =
//     +-0, and x + (+-0) == x for every x the sum can hold (it starts at
//     +0 and never becomes -0), given finite weights.  The block checks
//     its 768 staged weights and takes the dense 44-class loop when any
//     is not finite, so the result is exact for every table, with no host
//     sync;
//   * the RY gate is taken once per record, by a small first kernel (a
//     group of lanes a record, four packed bytes a compare with
//     __vcmpeq4) writing a keep byte to the caller's scratch, which every
//     position tile of the query block reads;
//   * the block's scalars (the contiguous R x 8 slab of rscal, qscal,
//     rec_rows, slot_qid and the weight table) arrive by 16- and 4-byte
//     cp.async.  The kept records are then grouped by slot in shared
//     memory (counts, prefix sums, one scatter), which gives each slot
//     its [start, end) range whatever the input order;
//   * each warp walks only the kept records whose window meets its 32
//     positions (a ballot compaction; 55% of them at L=128), gathering
//     kBatch target bytes at a time so their loads overlap, and counts
//     into its threads' columns of a 44 x 128 histogram that the first
//     touch of a cell writes, so nothing is cleared;
//   * the grid is (query block x position tile), so long levels fill the
//     132 SMs; every index is a 32-bit conditional wrap; the output bytes
//     (observed bases first, summed cells overwrite their 2 bits) are
//     assembled in shared memory and stored as 16-byte row pieces.
#include "common.cuh"

namespace {

constexpr int kTile = 128;       // positions per block = threads
constexpr int kMaxSlots = 128;   // largest query tile (G) accepted
constexpr int kMaxRecords = 512; // largest record tile (R) accepted
constexpr int kClasses = 44;
constexpr int kWarps = kTile / 32;
constexpr int kGateThreads = 256;
constexpr int kBatch = 8;        // records whose target bytes load together

// rscal fields; once the gate is taken, the block's copy holds the
// record's target shift (tstart - qstart) mod L in place of ry_smin and
// its keep flag (gate passed, has a slot) in place of use
constexpr int kQstart = 0, kTstart = 1, kAlen = 2, kSmin = 4, kShift = 4,
              kUse = 5, kSlot = 6;

// Offsets of the block's shared-memory arrays for G slots, R records.
// The slot order (ord, start, cnt) is only needed before the walk, so it
// lives in the histogram's space.
struct Layout {
  int rs, qs, w, rows, qid, list, nlist, hist, ord, start, cnt, out, bytes;
  __host__ __device__ Layout(int G, int R) {
    rs = 0;                                   // R x 8 int32
    qs = rs + R * 32;                         // G x 8 int32
    w = qs + G * 32;                          // 48 x 16 f32
    rows = w + 48 * 16 * 4;                   // R int32
    qid = rows + pad(R * 4);                  // G int32
    list = qid + pad(G * 4);                  // kWarps x R int16
    nlist = list + pad(kWarps * R * 2);       // kWarps int32
    hist = nlist + 16;                        // 44 x kTile uint32
    ord = hist;                               //   R int16
    start = ord + pad(R * 2);                 //   G + 1 int32
    cnt = start + pad((G + 1) * 4);           //   G int32
    out = hist + kClasses * kTile * 4;        // G/4 x kTile bytes
    bytes = out + (G / 4) * kTile;
  }
  __host__ __device__ static int pad(int n) { return (n + 15) & ~15; }
};

// RY identity of a record's window, 16 columns from column j of n:
// is_ct(q[lo + j + k]) == is_ct(t[(tcol + j + k) mod L]), four packed bytes
// per compare.
__device__ __forceinline__ int ry_step(const uint8_t* __restrict__ q,
                                       const uint8_t* __restrict__ t,
                                       int32_t L, int32_t lo, int32_t tcol,
                                       int32_t j, int32_t n) {
  const int nk = min(16, n - j);
  const uint4 x = cd::bytes16(q + lo + j, nk);  // inside the row: no wrap
  const uint4 y = cd::window16(t, L, cd::wrap_near(tcol + j, L), nk);
  const uint4 m = cd::tail_mask(nk);
  return cd::count_ff(make_uint4(~(cd::is_ct4(x.x) ^ cd::is_ct4(y.x)) & m.x,
                                 ~(cd::is_ct4(x.y) ^ cd::is_ct4(y.y)) & m.y,
                                 ~(cd::is_ct4(x.z) ^ cd::is_ct4(y.z)) & m.z,
                                 ~(cd::is_ct4(x.w) ^ cd::is_ct4(y.w)) & m.w));
}

// The RY identity window of a record: columns [lo, lo + n) of the query
// row, from (lo + shift) mod L in the target row.
struct RyWindow {
  int32_t lo, n, tcol;
  __device__ RyWindow(int32_t qstart, int32_t alen, int32_t shift,
                      int32_t L) {
    lo = max(qstart, 0);
    n = static_cast<int32_t>(min(static_cast<int64_t>(qstart) + alen,
                                 static_cast<int64_t>(L))) - lo;
    tcol = cd::wrap_near(lo + shift, L);
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

// RY identity gate of one record, taken by a group of `lanes` lanes (the
// whole group calls it): at least smin columns of its window agree.
__device__ __forceinline__ bool ry_gate(const uint8_t* __restrict__ q,
                                        const uint8_t* __restrict__ t,
                                        int32_t L, RyWindow win,
                                        int32_t smin, int sub, int lanes) {
  int ry = 0;
  for (int32_t j = 16 * sub; j < win.n; j += 16 * lanes)
    ry += ry_step(q, t, L, win.lo, win.tcol, j, win.n);
  return static_cast<int>(__reduce_add_sync(cd::group_mask(lanes), ry)) >=
         smin;
}

// The gate of every record, once, before the tiles of its query block
// need it: keep[b*R+i] = use && slot in [0, G) && RY gate.
__global__ void __launch_bounds__(kGateThreads)
correction_gate(const uint8_t* __restrict__ sym2, int32_t L,
                const int32_t* __restrict__ rec_rows,
                const int32_t* __restrict__ rscal,
                const int32_t* __restrict__ slot_qid, int32_t G, int32_t R,
                int64_t n_rec, int lanes, uint8_t* __restrict__ keep) {
  const int sub = threadIdx.x & (lanes - 1);
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * kGateThreads + threadIdx.x) / lanes;
  if (i >= n_rec) return;  // the whole group leaves together
  const int32_t* r = rscal + i * 8;
  const int32_t slot = r[kSlot];
  bool k = false;
  if (r[kUse] != 0 && slot >= 0 && slot < G) {
    const int64_t b = i / R;
    const RyWindow win(
        r[kQstart], r[kAlen],
        cd::wrap(static_cast<int64_t>(r[kTstart]) - r[kQstart], L), L);
    k = ry_gate(sym2 + static_cast<int64_t>(slot_qid[b * G + slot]) * L,
                sym2 + static_cast<int64_t>(rec_rows[i]) * L, L, win,
                r[kSmin], sub, lanes);
  }
  if (sub == 0) keep[i] = k;
}

// Class (targetBase*11 + damageLayer) of a record's column whose target
// byte is tbyte, at target position t_real of a target of length tl5 + 5;
// only 0-43 count (larger layers alias into the next base's classes, as
// in the TPU kernel; a negative id wraps to a large one and counts not).
__device__ __forceinline__ uint32_t column_class(int tbyte, int32_t t_real,
                                                int32_t tl5) {
  int layer = t_real < 5 ? t_real : 5;
  if (t_real - tl5 >= 0) layer = 6 + t_real - tl5;
  return static_cast<uint32_t>(cd::acgt_code(tbyte) * 11 + layer);
}

// The corrected base of slot s at this thread's position p (a cell with
// coverage tot >= 2), written into its 2 bits of the output byte in shared
// memory, which holds the observed base already: a cell with the ratio
// exit keeps it, any other takes the sum.  mask: the cell's classes with
// a count; hist: their counts, all records in bits 0-15 and reverse ones
// in bits 16-31.
__device__ __noinline__ void finish_cell(int s, uint64_t mask, int tot,
                                         int cov0, int cov3, int32_t p,
                                         const uint32_t* hist, const float* w,
                                         const int32_t* qs, uint8_t* obuf,
                                         int Q, bool dense) {
  const bool was_ext = qs[s * 8 + 1] != 0;
  if (!was_ext && (5 * cov3 >= 2 * tot || 5 * cov0 >= 2 * tot)) return;
  const int tid = threadIdx.x;
  uint8_t* byte = obuf + (s % Q) * kTile + tid;
  const int shift = 2 * (s / Q);
  const int obs = (*byte >> shift) & 3;

  float lik[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (uint64_t m = dense ? (1ull << kClasses) - 1 : mask; m; m &= m - 1) {
    const int c = __ffsll(static_cast<long long>(m)) - 1;
    const uint32_t h = (mask >> c) & 1 ? hist[c * kTile + tid] : 0u;
    const int rc = static_cast<int>(h >> 16);
    const float f = static_cast<float>(static_cast<int>(h & 0xffffu) - rc);
    const float rf = static_cast<float>(rc);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      lik[q] = __fadd_rn(__fadd_rn(lik[q], __fmul_rn(f, w[c * 16 + q])),
                         __fmul_rn(rf, w[c * 16 + 4 + q]));
    }
  }
  const int32_t qlen = qs[s * 8];
  int own = p < 5 ? p : 5;
  if (p - (qlen - 5) >= 0) own = 6 + p - (qlen - 5);
  const float tot_f = static_cast<float>(tot);
#pragma unroll
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
#pragma unroll
  for (int q = 1; q < 4; ++q) {
    if (lik[q] > best) {
      best = lik[q];
      bi = q;
    }
  }
  *byte = static_cast<uint8_t>((*byte & ~(3 << shift)) | (bi << shift));
}

// One block per (query block, position tile), after correction_gate has
// written `keep`.
__global__ void __launch_bounds__(kTile)
correction_kernel(const uint8_t* __restrict__ sym2, int32_t L,
                  const int32_t* __restrict__ rec_rows,
                  const int32_t* __restrict__ rscal,
                  const int32_t* __restrict__ slot_qid,
                  const int32_t* __restrict__ qscal,
                  const float* __restrict__ wtab, int32_t G, int32_t R,
                  int32_t tiles, const uint8_t* __restrict__ keep,
                  uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(G, R);
  int32_t* rs = reinterpret_cast<int32_t*>(smem + lay.rs);
  const int32_t* qs = reinterpret_cast<const int32_t*>(smem + lay.qs);
  const float* w = reinterpret_cast<const float*>(smem + lay.w);
  int32_t* rows = reinterpret_cast<int32_t*>(smem + lay.rows);
  int32_t* qid = reinterpret_cast<int32_t*>(smem + lay.qid);
  int16_t* ord = reinterpret_cast<int16_t*>(smem + lay.ord);
  int16_t* list = reinterpret_cast<int16_t*>(smem + lay.list);
  int32_t* nlist = reinterpret_cast<int32_t*>(smem + lay.nlist);
  int32_t* start = reinterpret_cast<int32_t*>(smem + lay.start);
  int32_t* cnt = reinterpret_cast<int32_t*>(smem + lay.cnt);
  uint32_t* hist = reinterpret_cast<uint32_t*>(smem + lay.hist);
  uint8_t* obuf = smem + lay.out;

  const int64_t b = blockIdx.x / tiles;
  const int32_t p0 = (blockIdx.x % tiles) * kTile;
  const int tid = threadIdx.x;
  const int Q = G / 4;

  // ---- stage the block's scalars ---------------------------------------
  {
    const char* src = reinterpret_cast<const char*>(rscal + b * R * 8);
    for (int k = tid; k < R * 2; k += kTile)
      cp_async16(smem + lay.rs + 16 * k, src + 16 * k);
    src = reinterpret_cast<const char*>(qscal + b * G * 8);
    for (int k = tid; k < G * 2; k += kTile)
      cp_async16(smem + lay.qs + 16 * k, src + 16 * k);
    src = reinterpret_cast<const char*>(wtab);
    for (int k = tid; k < 48 * 16 / 4; k += kTile)
      cp_async16(smem + lay.w + 16 * k, src + 16 * k);
    for (int k = tid; k < R; k += kTile)
      cp_async4(rows + k, rec_rows + b * R + k);
    for (int k = tid; k < G; k += kTile)
      cp_async4(qid + k, slot_qid + b * G + k);
    asm volatile("cp.async.wait_all;\n" ::);
  }
  for (int s = tid; s < G; s += kTile) cnt[s] = 0;
  __syncthreads();
  bool bad_w = false;
  for (int k = tid; k < 48 * 16; k += kTile) bad_w |= !isfinite(w[k]);
  const bool dense = __syncthreads_or(bad_w);

  // ---- keep flag and target shift of every record ----------------------
  for (int i = tid; i < R; i += kTile) {
    int32_t* r = rs + i * 8;
    r[kShift] = cd::wrap(static_cast<int64_t>(r[kTstart]) - r[kQstart], L);
    r[kUse] = keep[b * R + i];
    if (r[kUse]) atomicAdd(&cnt[r[kSlot]], 1);
  }
  __syncthreads();

  // ---- kept records grouped by slot: [start[s], start[s+1]) of ord -----
  // (the order inside a slot is free: counts do not depend on it)
  if (tid < G) {
    int32_t sum = 0;
    for (int t = 0; t < tid; ++t) sum += cnt[t];
    start[tid] = sum;
    if (tid == G - 1) start[G] = sum + cnt[tid];
  }
  __syncthreads();
  for (int i = tid; i < R; i += kTile) {
    if (rs[i * 8 + kUse]) {
      const int32_t slot = rs[i * 8 + kSlot];
      ord[start[slot] + atomicSub(&cnt[slot], 1) - 1] =
          static_cast<int16_t>(i);
    }
  }

  // ---- the observed bases: what every cell writes unless it sums; a
  // thread takes 16 positions of the four slots of an output byte -------
  for (int k = tid; k < Q * (kTile / 16); k += kTile) {
    const int g = k / (kTile / 16), c = 16 * (k % (kTile / 16));
    const int nk = min(16, L - p0 - c);
    if (nk <= 0) continue;
    uint4 packed = make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint4 x = cd::bytes16(
          sym2 + static_cast<int64_t>(qid[g + j * Q]) * L + p0 + c, nk);
      packed.x |= cd::acgt_code4(x.x) << (2 * j);
      packed.y |= cd::acgt_code4(x.y) << (2 * j);
      packed.z |= cd::acgt_code4(x.z) << (2 * j);
      packed.w |= cd::acgt_code4(x.w) << (2 * j);
    }
    *reinterpret_cast<uint4*>(obuf + g * kTile + c) = packed;
  }
  __syncthreads();

  const int32_t p = p0 + tid;

  // ---- each warp's records: the kept records (slot by slot) whose
  // window meets the warp's 32 positions ---------------------------------
  const int warp = tid >> 5, lane = tid & 31;
  int16_t* wlist = list + warp * R;
  {
    const int32_t wlo = p0 + 32 * warp, whi = min(wlo + 32, L);
    const int n_kept = start[G];
    int n = 0;
    for (int k0 = 0; k0 < n_kept; k0 += 32) {
      int16_t i = 0;
      bool meets = false;
      if (k0 + lane < n_kept) {
        i = ord[k0 + lane];
        const int32_t qstart = rs[i * 8 + kQstart], alen = rs[i * 8 + kAlen];
        meets = alen > 0 && qstart < whi &&
                static_cast<int64_t>(qstart) + alen > wlo;
      }
      const unsigned ball = __ballot_sync(cd::kFullMask, meets);
      if (meets) wlist[n + __popc(ball & ((1u << lane) - 1u))] = i;
      n += __popc(ball);
    }
    if (lane == 0) nlist[warp] = n;
  }
  __syncthreads();  // the walk's histogram overwrites ord and start

  // ---- one position per thread: walk the warp's records slot by slot,
  // gathering kBatch target bytes at a time, counting into this thread's
  // column of hist (first touch writes, so nothing is cleared) ----------
  if (p < L) {
    const int4* rs4 = reinterpret_cast<const int4*>(rs);
    const int n_rec = nlist[warp];
    int cur = -1, tot = 0, cov0 = 0, cov3 = 0;
    uint64_t mask = 0;
    for (int k0 = 0; k0 < n_rec; k0 += kBatch) {
      // gather the batch first: every lane loads (the address is in its
      // row whether or not the record covers p), so the loads issue
      // together; what the counting needs stays in registers
      uint32_t v[kBatch];
      int32_t t_real[kBatch], tl5[kBatch], meta[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = wlist[min(k0 + k, n_rec - 1)];
        const int4 a = rs4[2 * i], bb = rs4[2 * i + 1];
        const int32_t d = p - a.x;
        v[k] = sym2[static_cast<int64_t>(rows[i]) * L +
                    cd::wrap_near(p + bb.x, L)];
        t_real[k] = a.y + d;
        tl5[k] = a.w - 5;
        // slot, is_rev in bit 8, covers-p in bit 9
        meta[k] = bb.z | (bb.w != 0 ? 1 << 8 : 0) |
                  (k0 + k < n_rec && d >= 0 && d < a.z ? 1 << 9 : 0);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (k0 + k >= n_rec) break;
        const int slot = meta[k] & 0xff;
        if (slot != cur) {
          if (tot >= 2) {
            finish_cell(cur, mask, tot, cov0, cov3, p, hist, w, qs, obuf, Q,
                        dense);
          }
          cur = slot;
          mask = 0;
          tot = cov0 = cov3 = 0;
        }
        if (!(meta[k] & (1 << 9))) continue;
        const uint32_t c = column_class(v[k], t_real[k], tl5[k]);
        if (c >= static_cast<uint32_t>(kClasses)) continue;
        ++tot;
        cov0 += c < 11;
        cov3 += c >= 33;
        const uint32_t inc = 1u + ((meta[k] >> 8 & 1) << 16);
        uint32_t* h = hist + c * kTile + tid;
        *h = (mask >> c) & 1 ? *h + inc : inc;
        mask |= 1ull << c;
      }
    }
    if (tot >= 2) {
      finish_cell(cur, mask, tot, cov0, cov3, p, hist, w, qs, obuf, Q,
                  dense);
    }
  }
  __syncthreads();

  // ---- whole output rows ------------------------------------------------
  const int32_t cols = min(kTile, L - p0);
  uint8_t* orow = out + b * Q * static_cast<int64_t>(L) + p0;
  if ((L & 15) == 0) {
    const int per_row = cols / 16;
    for (int k = tid; k < Q * per_row; k += kTile) {
      const int g = k / per_row, c = k % per_row;
      *reinterpret_cast<uint4*>(orow + static_cast<int64_t>(g) * L + 16 * c) =
          *reinterpret_cast<const uint4*>(obuf + g * kTile + 16 * c);
    }
  } else {
    for (int k = tid; k < Q * cols; k += kTile) {
      const int g = k / cols, c = k % cols;
      orow[static_cast<int64_t>(g) * L + c] = obuf[g * kTile + c];
    }
  }
}

}  // namespace

// `keep` is scratch of nb*R bytes: the gate kernel's output.
// rscal, qscal and wtab must be 16-byte aligned (the wrapper checks).
CD_EXPORT int cd_correction(const void* sym2, int64_t L, const void* rec_rows,
                            const void* rscal, const void* slot_qid,
                            const void* qscal, const void* wtab, int64_t nb,
                            int64_t G, int64_t R, void* keep, void* out,
                            void* stream) {
  if (G <= 0 || G % 4 != 0 || G > kMaxSlots || R <= 0 || R > kMaxRecords ||
      L <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* sym = static_cast<const uint8_t*>(sym2);
  const auto* rows = static_cast<const int32_t*>(rec_rows);
  const auto* rsc = static_cast<const int32_t*>(rscal);
  const auto* qid = static_cast<const int32_t*>(slot_qid);
  const auto* qsc = static_cast<const int32_t*>(qscal);
  const auto* wt = static_cast<const float*>(wtab);
  const int32_t Li = static_cast<int32_t>(L);
  const int32_t Gi = static_cast<int32_t>(G), Ri = static_cast<int32_t>(R);
  const int32_t tiles = static_cast<int32_t>((L + kTile - 1) / kTile);
  const size_t bytes = static_cast<size_t>(Layout(Gi, Ri).bytes);
  auto* o = static_cast<uint8_t*>(out);
  cudaError_t e = cudaFuncSetAttribute(
      correction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int lanes = cd::lanes_for(L);
  const int64_t n_rec = nb * R;
  auto* k = static_cast<uint8_t*>(keep);
  correction_gate<<<static_cast<unsigned>(
                        (n_rec * lanes + kGateThreads - 1) / kGateThreads),
                    kGateThreads, 0, s>>>(sym, Li, rows, rsc, qid, Gi, Ri,
                                          n_rec, lanes, k);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  correction_kernel<<<static_cast<unsigned>(nb * tiles), kTile, bytes, s>>>(
      sym, Li, rows, rsc, qid, qsc, wt, Gi, Ri, tiles, k, o);
  return static_cast<int>(cudaGetLastError());
}
