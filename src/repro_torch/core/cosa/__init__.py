"""Extended CoSA: constrained-optimization scheduling for GEMM accelerators.

Paper §3.1 — CoSA [Huang et al., ISCA'21] formulates tensor scheduling as a
MIP over a binary 4-D assignment matrix X[j, n, i, k]:

  j — layer dimension variable (GEMM dims N, C, K),
  n — prime factor of the dim's loop bound,
  i — memory / permutation level,
  k — spatial (1) or temporal (0) mapping.

This package reimplements that formulation (``mip.py``, solved with
PuLP/CBC) and adds the paper's extensions: instruction-set loop-factor
limits (Eq. 1), fixed dataflows, uneven-mapping memory shares and double
buffering.  ``heuristic.py`` is a dependency-free fallback solver;
``factors.py`` provides padding/factorization utilities.

Port of ``repro.core.cosa``.
"""

from repro_torch.core.cosa.factors import pad_to_alignment, prime_factors
from repro_torch.core.cosa.mip import CosaMIP, solve_mip
from repro_torch.core.cosa.heuristic import solve_heuristic

__all__ = [
    "prime_factors",
    "pad_to_alignment",
    "CosaMIP",
    "solve_mip",
    "solve_heuristic",
]
