"""xxHash64 of a single little-endian uint64, vectorised.

The reference subsamples k-mers by `XXH64(&kmer, 8, seed)` truncated to 16
bits (lib/mmseqs/src/linclust/kmermatcher.cpp:33-38,164).  For an 8-byte
input the algorithm collapses to a short fixed formula, implemented here
over NumPy uint64 arrays (and usable under JAX with x64 enabled).

All arithmetic is modulo 2**64.
"""
from __future__ import annotations

import numpy as np

P1 = np.uint64(0x9E3779B185EBCA87)
P2 = np.uint64(0xC2B2AE3D27D4EB4F)
P3 = np.uint64(0x165667B19E3779F9)
P4 = np.uint64(0x85EBCA77C2B2AE63)
P5 = np.uint64(0x27D4EB2F165667C5)

_err = np.seterr  # silence overflow warnings locally


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    r = np.uint64(r)
    return (x << r) | (x >> (np.uint64(64) - r))


def xxh64_u64(value, seed: int) -> np.ndarray:
    """XXH64 of each 8-byte little-endian uint64 in `value` with `seed`."""
    old = np.seterr(over="ignore")
    try:
        v = np.asarray(value, dtype=np.uint64)
        seed = np.uint64(seed)
        # single 8-byte lane: one round absorbed into acc
        k1 = _rotl(v * P2, 31) * P1
        acc = seed + P5 + np.uint64(8)
        acc = acc ^ k1
        acc = _rotl(acc, 27) * P1 + P4
        # avalanche
        acc ^= acc >> np.uint64(33)
        acc *= P2
        acc ^= acc >> np.uint64(29)
        acc *= P3
        acc ^= acc >> np.uint64(32)
        return acc
    finally:
        np.seterr(**old)


def hash16(value, seed: int) -> np.ndarray:
    """The 16-bit k-mer subsampling hash (`unsigned short` truncation)."""
    return (xxh64_u64(value, seed) & np.uint64(0xFFFF)).astype(np.uint16)


def util_hash_codes_batch(flat_codes: np.ndarray, offsets: np.ndarray,
                          lengths: np.ndarray) -> np.ndarray:
    """Util::hash (polynomial hash, base 31) of each sequence of numeric
    codes stored CSR-style, used for the whole-sequence identity k-mer
    (lib/mmseqs/src/commons/Util.h:336-345, kmermatcher.cpp:136):
    h = 0; for each code x: h = h*31 + x   (mod 2^64).

    Vectorised over sequences via a position-major loop (max length bound);
    cheap because h updates are elementwise.
    """
    old = np.seterr(over="ignore")
    try:
        n = len(offsets)
        h = np.zeros(n, dtype=np.uint64)
        maxlen = int(lengths.max()) if n else 0
        a = np.uint64(31)
        flat = np.asarray(flat_codes, dtype=np.uint64)
        offsets = np.asarray(offsets, dtype=np.int64)
        lengths = np.asarray(lengths, dtype=np.int64)
        for pos in range(maxlen):
            active = lengths > pos
            x = flat[offsets[active] + pos]
            h[active] = h[active] * a + x
        return h
    finally:
        np.seterr(**old)
