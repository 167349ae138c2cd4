"""Prime-factor utilities for the CoSA schedule space.

CoSA's variable space is indexed by the *prime factors* of each loop bound:
assigning factor n of dim j to level i (spatially or temporally) builds the
tile sizes multiplicatively.  Real layer dims are often prime-factor-hostile
(e.g. 27392 = 2^8 * 107), so — like Gemmini's own toolchain — we pad dims up
to hardware alignment first and, when a dim still contains a huge prime,
round it up to the next "smooth" number so the factor space is rich enough
for the MIP to tile well.  Padding waste is charged by the cycle model via
``Schedule.utilization``.

Port of ``repro.core.cosa.factors``: plain Python and numpy, copied with import changes
only unless noted here.
"""

from __future__ import annotations

import math
from functools import lru_cache


@lru_cache(maxsize=4096)
def prime_factors(n: int) -> tuple[int, ...]:
    """Prime factorization with multiplicity, ascending. prime_factors(12) = (2,2,3)."""
    if n < 1:
        raise ValueError("n must be >= 1")
    out: list[int] = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1 if d == 2 else 2
    if n > 1:
        out.append(n)
    return tuple(out)


def is_smooth(n: int, bound: int = 13) -> bool:
    """True if every prime factor of n is <= bound."""
    return all(p <= bound for p in prime_factors(n))


@lru_cache(maxsize=4096)
def next_smooth(n: int, bound: int = 13) -> int:
    """Smallest m >= n whose prime factors are all <= bound."""
    m = n
    while not is_smooth(m, bound):
        m += 1
    return m


def pad_to_alignment(n: int, align: int, smooth_bound: int = 13) -> int:
    """Round n up to a multiple of `align` that is also smooth.

    Alignment models the TPU lane/sublane (or Gemmini DIM) granularity;
    smoothness keeps the CoSA factor space tractable and tileable.
    """
    m = ((n + align - 1) // align) * align
    # Pad in units of `align` until the quotient is smooth; the quotient is
    # what the scheduler actually has to tile above the alignment unit.
    while not is_smooth(m // math.gcd(m, align) if align > 1 else m, smooth_bound) and (
        not is_smooth(m, smooth_bound)
    ):
        m += align
    return m


def factor_products(factors: tuple[int, ...]) -> set[int]:
    """All products formable from a subset of `factors` (tile-size candidates)."""
    prods = {1}
    for f in factors:
        prods |= {p * f for p in prods}
    return prods
