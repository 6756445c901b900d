"""2-bit k-mer packing, reverse complement and canonicalisation.

Replicates Indexer::computeKmerIdx (big-endian 2-bit packing, code order
A=0 C=1 T=2 G=3; lib/mmseqs/src/prefiltering/Indexer.h:136-143) and
Util::revComplement (complement = code XOR 2, reverse 2-bit groups;
lib/mmseqs/src/commons/Util.cpp:601-640) as vectorised NumPy uint64 ops.
"""
from __future__ import annotations

import numpy as np

_M2 = np.uint64(0x3333333333333333)
_M4 = np.uint64(0x0F0F0F0F0F0F0F0F)
_COMP = np.uint64(0xAAAAAAAAAAAAAAAA)  # XOR 0b10 in every 2-bit lane


def revcomp_kmer(idx: np.ndarray, k: int) -> np.ndarray:
    """Reverse complement of packed k-mers (vectorised bit magic)."""
    old = np.seterr(over="ignore")
    try:
        x = np.asarray(idx, dtype=np.uint64) ^ _COMP  # complement each base
        # reverse 2-bit groups within 64 bits:
        x = ((x >> np.uint64(2)) & _M2) | ((x & _M2) << np.uint64(2))
        x = ((x >> np.uint64(4)) & _M4) | ((x & _M4) << np.uint64(4))
        x = x.byteswap() if x.dtype.byteorder in ("=", "<") else x
        # byteswap reverses bytes; combined with the in-byte swaps above the
        # full 32-base word is reversed.  Shift out unused positions:
        return x >> np.uint64(64 - 2 * k)
    finally:
        np.seterr(**old)


BIT63 = np.uint64(1) << np.uint64(63)


def canonicalize(idx: np.ndarray, k: int):
    """Canonical k-mer = min(idx, revcomp); returns (canonical, pick_reverse,
    palindrome) matching kmermatcher.cpp:155-163 (palindromes are skipped)."""
    rc = revcomp_kmer(idx, k)
    palindrome = rc == idx
    pick_reverse = rc < idx
    canonical = np.where(pick_reverse, rc, idx)
    return canonical, pick_reverse, palindrome
