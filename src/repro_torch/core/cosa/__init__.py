"""Extended CoSA: constrained-optimization scheduling for GEMM accelerators
(paper §3.1).

Port of ``repro.core.cosa``: ``factors.py`` (padding and factorization)
and ``heuristic.py`` (the greedy solver).  The MIP formulation
(``repro.core.cosa.mip``) is not ported yet; the scheduler runs the
heuristic, as the reference does without ``pulp``.
"""

from repro_torch.core.cosa.factors import pad_to_alignment, prime_factors
from repro_torch.core.cosa.heuristic import solve_heuristic

__all__ = ["prime_factors", "pad_to_alignment", "solve_heuristic"]
