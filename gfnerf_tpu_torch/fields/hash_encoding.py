"""Numpy helpers of the anchored hash encoding.

Copies of ``gfnerf_tpu/fields/hash_encoding.py``'s prime sampling and level
scales (Hash3DAnchored.cpp:39-54, Hash3DAnchored_cuda.cu:28), so that the
port draws the same primes from the same numpy generator.  The anchored
encode itself is not ported yet.
"""

from __future__ import annotations

import numpy as np

N_CHANNELS = 2          # Hash3DAnchored.h:17
N_LEVELS = 16           # Hash3DAnchored.h:18
RES_FINE_POW_2 = 10.0   # Hash3DAnchored.h:20
RES_BASE_POW_2 = 3.0    # Hash3DAnchored.h:22


def _is_prime_vec(n: np.ndarray) -> np.ndarray:
    """Deterministic Miller-Rabin for 32-bit ints (bases 2, 7, 61), vectorized."""
    n = n.astype(np.uint64)
    res = np.ones(n.shape, dtype=bool)
    res &= (n % 2 == 1) & (n > 2)
    d = (n - 1) >> 1
    r = np.ones_like(n)
    more = (d % 2 == 0)
    while more.any():
        d = np.where(more, d >> 1, d)
        r = np.where(more, r + 1, r)
        more = more & (d % 2 == 0)

    def powmod(base, exp, mod):
        out = np.ones_like(mod)
        b = base % mod
        e = exp.copy()
        while (e > 0).any():
            bit = (e & 1).astype(bool)
            out = np.where(bit, (out * b) % mod, out)
            e = e >> 1
            b = (b * b) % mod
        return out

    for a in (2, 7, 61):
        a_arr = np.full_like(n, a)
        x = powmod(a_arr, d, n)
        ok = (x == 1) | (x == n - 1)
        cur = x.copy()
        for i in range(32):
            cur = (cur * cur) % n
            ok |= (cur == n - 1) & (np.uint64(i + 1) < r)
        res &= ok | (n == a)
    return res


def _random_primes(rng: np.random.Generator, count: int) -> np.ndarray:
    """Random primes in [2^28, 2^30) (Hash3DAnchored.cpp:39-54)."""
    out = np.empty((count,), dtype=np.uint32)
    n = 0
    while n < count:
        cand = rng.integers(1 << 28, 1 << 30, size=max(2 * (count - n), 64),
                            dtype=np.int64)
        cand = cand[_is_prime_vec(cand)]
        take = min(len(cand), count - n)
        out[n:n + take] = cand[:take].astype(np.uint32)
        n += take
    return out


def _level_scales(n_levels: int) -> np.ndarray:
    """Per-level resolution multiplier exp2(3 + 7*l/(L-1)) (_cuda.cu:28)."""
    levels = np.arange(n_levels, dtype=np.float32)
    return np.exp2(
        (RES_FINE_POW_2 - RES_BASE_POW_2) * levels / float(n_levels - 1)
        + RES_BASE_POW_2
    )
