"""Memory-optimized two-stage routing theory (paper §II + Appendix A).

All equations follow the paper's notation:

  N : total number of neurons in the network
  F : fan-out per neuron
  C : cluster (core) size
  K : number of distinct tags per cluster (K = alpha * C)
  M : second-stage (broadcast) fan-out; stage-1 point-to-point fan-out is F/M

Source memory  MEM_S = (F/M) * (log2(K) + log2(N/C))       [eq. MEM_S, bits/neuron]
Target memory  MEM_T = (K*M/C) * log2(K)                   [bits/neuron]
Total          MEM   = (F/M) * log2(K*N/C) + (K*M/C)*log2(K)      (eq. 2)
With K = alpha*C:
               MEM   = (F/M) * log2(alpha*N) + alpha*M*log2(alpha*C)  (eq. 3)
Optimal        M*    = sqrt( F*log2(alpha*N) / (alpha*log2(alpha*C)) ) (eq. 5)
At M*:         MEM   = 2*sqrt(alpha*F*log2(alpha*C)*log2(alpha*N))     (eq. 6 general)
For alpha=1:   MEM   = 2*sqrt(F*log2(C)*log2(N))                       (eq. 6)

Conventional (source/destination-addressed) routing: F*log2(N) bits/neuron.

Counterpart of ``repro.core.memory_model``: pure functions of python
scalars, used by the compile report (core/compiler.py ``build_report``) to
evaluate eq.(2) at a compiled network's empirical fan-outs.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = [
    "RoutingParams",
    "mem_source_bits",
    "mem_target_bits",
    "mem_total_bits",
    "mem_total_bits_alpha",
    "optimal_m",
    "optimal_m_integer",
    "mem_at_optimal_m",
    "conventional_bits",
    "feasible",
    "constraint_c_lower_bound",
    "paper_prototype_params",
]


@dataclasses.dataclass(frozen=True)
class RoutingParams:
    """A concrete design point of the two-stage routing scheme."""

    n: int  # total neurons N
    f: int  # fan-out F
    c: int  # cluster size C
    m: int  # second-stage fan-out M
    alpha: float = 1.0  # K / C

    @property
    def k(self) -> int:
        """Tags per cluster."""
        return max(1, int(round(self.alpha * self.c)))

    @property
    def n_clusters(self) -> int:
        """Clusters needed to host N neurons — ceil, so a ragged tail cluster
        (n % c != 0) is counted instead of silently dropping its neurons
        from feasibility/traffic numbers."""
        return max(1, math.ceil(self.n / self.c))

    @property
    def stage1_fanout(self) -> int:
        """Entries in the source (SRAM) table per neuron: F/M point-to-point copies."""
        return max(1, math.ceil(self.f / self.m))

    @property
    def cam_words_per_neuron(self) -> int:
        """Target (CAM) entries per neuron: K*M/C assuming uniform tag use."""
        return max(1, math.ceil(self.k * self.m / self.c))


def mem_source_bits(n: float, f: float, c: float, m: float, k: float) -> float:
    """MEM_S = (F/M) * (log2 K + log2 (N/C)) bits per neuron."""
    return (f / m) * (math.log2(k) + math.log2(n / c))


def mem_target_bits(c: float, m: float, k: float) -> float:
    """MEM_T = (K*M/C) * log2 K bits per neuron."""
    return (k * m / c) * math.log2(k)


def mem_total_bits(n: float, f: float, c: float, m: float, k: float) -> float:
    """Eq. (2): total bits/neuron for a given design point."""
    return mem_source_bits(n, f, c, m, k) + mem_target_bits(c, m, k)


def mem_total_bits_alpha(n: float, f: float, c: float, m: float, alpha: float = 1.0) -> float:
    """Eq. (3): total bits/neuron with K = alpha*C substituted."""
    return (f / m) * math.log2(alpha * n) + alpha * m * math.log2(alpha * c)


def optimal_m(n: float, f: float, c: float, alpha: float = 1.0) -> float:
    """Eq. (5): M* = sqrt(F log2(alpha N) / (alpha log2(alpha C)))."""
    return math.sqrt(f * math.log2(alpha * n) / (alpha * math.log2(alpha * c)))


def optimal_m_integer(n: float, f: float, c: float, alpha: float = 1.0) -> int:
    """Integer argmin of eq.(3) over the feasible M in [1, min(F, C)].

    Eq.(5)'s M* is real-valued; hardware picks an integer second-stage
    fan-out. Eq.(3) is strictly convex in M (a/M + b*M with a, b > 0), so
    the integer optimum is one of floor(M*)/ceil(M*) clamped into range —
    checked explicitly so the property test can compare against brute force.
    """
    hi = max(1, int(min(f, c)))
    m_star = optimal_m(n, f, c, alpha)
    candidates = {1, hi}
    for m in (math.floor(m_star), math.ceil(m_star)):
        if 1 <= m <= hi:
            candidates.add(int(m))
    return min(candidates, key=lambda m: (mem_total_bits_alpha(n, f, c, m, alpha), m))


def mem_at_optimal_m(n: float, f: float, c: float, alpha: float = 1.0) -> float:
    """Eq. (6) generalized: 2*sqrt(alpha F log2(alpha C) log2(alpha N))."""
    return 2.0 * math.sqrt(alpha * f * math.log2(alpha * c) * math.log2(alpha * n))


def conventional_bits(n: float, f: float) -> float:
    """Flat source/destination-addressed routing: F*log2(N) bits/neuron."""
    return f * math.log2(n)


def feasible(n: float, f: float, c: float, alpha: float = 1.0) -> bool:
    """Appendix-A feasibility of the optimal design point: M* <= F and M* <= C."""
    m_star = optimal_m(n, f, c, alpha)
    return m_star <= f and m_star <= c


def constraint_c_lower_bound(n: float, f: float) -> float:
    """Appendix A (alpha=1): smallest C with C*sqrt(log2 C) >= sqrt(F log2 N).

    Solved numerically by bisection (the LHS is monotone for C >= 2).
    """
    target = math.sqrt(f * math.log2(n))

    def lhs(c: float) -> float:
        return c * math.sqrt(math.log2(c))

    lo, hi = 2.0, 2.0
    while lhs(hi) < target:
        hi *= 2.0
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if lhs(mid) < target:
            lo = mid
        else:
            hi = mid
    return hi


def paper_prototype_params() -> RoutingParams:
    """The fabricated prototype's design point (§III-B / §IV).

    256 neurons/core, 4 cores/chip, fan-out 4k, 64 CAM words per neuron
    (K*M/C = 64 as used for Fig. 13), K = C = 256 (alpha = 1), M = 64.
    """
    return RoutingParams(n=1024, f=4096, c=256, m=64, alpha=1.0)
