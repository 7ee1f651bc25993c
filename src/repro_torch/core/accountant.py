"""Renyi-DP accountant for the Sampled Gaussian Mechanism (SGM).

The port's own copy of ``repro.core.accountant`` (pure Python and NumPy),
kept line for line so ε is bit-identical to the reference's.

Pure-Python/NumPy replacement for the Opacus/TF-privacy accountant the paper
relies on (Mironov, Talwar, Zhang, "Renyi Differential Privacy of the Sampled
Gaussian Mechanism", 2019).  DeCaPH trains with DP-SGD semantics on the
*aggregate* dataset: Poisson subsampling at global rate ``p``, noise multiplier
``sigma`` applied to the clipped gradient sum, composed over ``T`` rounds.

The accountant computes RDP orders ``eps(alpha)`` of one SGM step:

    A(alpha) = E_{z~mu0} [ ((1-p) + p * exp((2z-1)/(2 sigma^2)))^alpha ]

using the stable closed forms from Mironov et al. (integer alpha: binomial
expansion; fractional alpha: the two-term integral split at z=1/2 evaluated
with log-erfc), then composes linearly over steps and converts to
(epsilon, delta)-DP.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np

DEFAULT_ORDERS: tuple[float, ...] = tuple(
    [1.0 + x / 10.0 for x in range(1, 100)] + list(range(11, 64)) + [128, 256, 512]
)


def _log_comb(n: int, k: int) -> float:
    return math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)


def _log_add(a: float, b: float) -> float:
    """log(exp(a) + exp(b)), stable."""
    if a == -math.inf:
        return b
    if b == -math.inf:
        return a
    hi, lo = (a, b) if a > b else (b, a)
    return hi + math.log1p(math.exp(lo - hi))


def _log_sub(a: float, b: float) -> float:
    """log(exp(a) - exp(b)) for a >= b, stable."""
    if b == -math.inf:
        return a
    if a == b:
        return -math.inf
    if a < b:
        raise ValueError("log_sub requires a >= b")
    return a + math.log1p(-math.exp(b - a))


def _log_erfc(x: float) -> float:
    """log(erfc(x)), stable for large positive x (asymptotic expansion)."""
    try:
        val = math.erfc(x)
    except OverflowError:  # pragma: no cover
        val = 0.0
    if val > 1e-300:
        return math.log(val)
    # Asymptotic series erfc(x) ~ exp(-x^2)/(x sqrt(pi)) * (1 - 1/(2x^2) + ...)
    return (
        -(x**2)
        - math.log(x)
        - 0.5 * math.log(math.pi)
        + math.log1p(-0.5 / (x**2) + 0.75 / (x**4))
    )


def _compute_log_a_int(p: float, sigma: float, alpha: int) -> float:
    """log(A(alpha)) for integer alpha >= 1 (binomial expansion)."""
    log_a = -math.inf
    for k in range(alpha + 1):
        term = (
            _log_comb(alpha, k)
            + k * math.log(p)
            + (alpha - k) * math.log1p(-p)
            + (k * k - k) / (2.0 * sigma**2)
        )
        log_a = _log_add(log_a, term)
    return log_a


def _signed_log_binom_frac(alpha: float, i: int) -> tuple[int, float]:
    """(sign, log|binom(alpha, i)|) for real non-integer alpha > 1.

    binom(alpha, i) = alpha (alpha-1) ... (alpha-i+1) / i!; the sign alternates
    once i exceeds alpha.
    """
    if i == 0:
        return 1, 0.0
    sign, log_num = 1, 0.0
    for j in range(i):
        v = alpha - j
        if v < 0:
            sign = -sign
            v = -v
        log_num += math.log(v)
    return sign, log_num - math.lgamma(i + 1)


def _compute_log_a_frac(p: float, sigma: float, alpha: float) -> float:
    """log(A(alpha)) for fractional alpha (Mironov et al. Sec. 3.3).

    Splits the SGM integral at z0 = sigma^2 log(1/p - 1) + 1/2 and evaluates
    each half with the binomial series + log-erfc; the series terms alternate
    in sign once i > alpha, so signs are tracked explicitly.
    """
    log_a0, log_a1 = -math.inf, -math.inf
    i = 0
    z0 = sigma**2 * math.log(1.0 / p - 1.0) + 0.5
    while True:  # terms decay superexponentially; break on convergence
        sign, log_coef = _signed_log_binom_frac(alpha, i)
        j = alpha - i
        log_t0 = log_coef + i * math.log(p) + j * math.log1p(-p)
        log_t1 = log_coef + j * math.log(p) + i * math.log1p(-p)
        log_e0 = math.log(0.5) + _log_erfc((i - z0) / (math.sqrt(2.0) * sigma))
        log_e1 = math.log(0.5) + _log_erfc((z0 - j) / (math.sqrt(2.0) * sigma))
        log_s0 = log_t0 + (i * i - i) / (2.0 * sigma**2) + log_e0
        log_s1 = log_t1 + (j * j - j) / (2.0 * sigma**2) + log_e1
        if sign > 0:
            log_a0 = _log_add(log_a0, log_s0)
            log_a1 = _log_add(log_a1, log_s1)
        else:
            log_a0 = _log_sub(log_a0, log_s0)
            log_a1 = _log_sub(log_a1, log_s1)
        i += 1
        if max(log_s0, log_s1) < -30.0:
            break
        if i > 2048:  # safety bound; series has long converged in practice
            break
    return _log_add(log_a0, log_a1)


def compute_rdp_sgm(
    p: float, sigma: float, steps: int, orders: Sequence[float] = DEFAULT_ORDERS
) -> np.ndarray:
    """RDP of ``steps`` compositions of the sampled Gaussian mechanism.

    Args:
      p: Poisson subsampling rate (aggregate over all participants in DeCaPH).
      sigma: noise multiplier (noise stddev = sigma * clip_norm on the SUM).
      steps: number of composed steps (communication rounds).
      orders: RDP orders alpha > 1.

    Returns:
      array of RDP epsilons, one per order.
    """
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"sampling rate must be in [0,1], got {p}")
    if sigma < 0:
        raise ValueError("sigma must be >= 0")
    rdp = np.zeros(len(orders), dtype=np.float64)
    for idx, alpha in enumerate(orders):
        if alpha <= 1.0:
            raise ValueError("RDP orders must be > 1")
        if sigma == 0.0 or p == 1.0 and sigma == 0.0:
            rdp[idx] = math.inf
            continue
        if p == 0.0:
            rdp[idx] = 0.0
            continue
        if sigma == 0.0:
            rdp[idx] = math.inf
            continue
        if p == 1.0:
            # Plain Gaussian mechanism.
            eps_alpha = alpha / (2.0 * sigma**2)
        else:
            if float(alpha).is_integer():
                log_a = _compute_log_a_int(p, sigma, int(alpha))
            else:
                log_a = _compute_log_a_frac(p, sigma, alpha)
            eps_alpha = log_a / (alpha - 1.0)
        rdp[idx] = eps_alpha * steps
    return rdp


def rdp_to_eps_delta(
    rdp: np.ndarray, orders: Sequence[float], delta: float
) -> tuple[float, float]:
    """Convert RDP curve to (epsilon, delta)-DP; returns (eps, best_order).

    Uses the classic Mironov conversion the paper cites:
        eps = rdp(alpha) + log(1/delta) / (alpha - 1),
    minimised over orders.
    """
    if not 0.0 < delta < 1.0:
        raise ValueError("delta must be in (0,1)")
    orders = np.asarray(orders, dtype=np.float64)
    eps = rdp + math.log(1.0 / delta) / (orders - 1.0)
    i = int(np.nanargmin(eps))
    return float(eps[i]), float(orders[i])


def compute_epsilon(
    p: float,
    sigma: float,
    steps: int,
    delta: float,
    orders: Sequence[float] = DEFAULT_ORDERS,
) -> float:
    """End-to-end epsilon for DeCaPH training (aggregate-dataset DP-SGD)."""
    if p == 0.0 or steps == 0:
        return 0.0  # mechanism never touches data
    rdp = compute_rdp_sgm(p, sigma, steps, orders)
    eps, _ = rdp_to_eps_delta(rdp, orders, delta)
    return eps


def steps_for_epsilon(
    p: float, sigma: float, target_eps: float, delta: float,
    orders: Sequence[float] = DEFAULT_ORDERS, max_steps: int = 1_000_000,
) -> int:
    """Largest number of steps with epsilon <= target (binary search)."""
    lo, hi = 0, 1
    while hi < max_steps and compute_epsilon(p, sigma, hi, delta, orders) <= target_eps:
        lo, hi = hi, hi * 2
    hi = min(hi, max_steps)
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        if compute_epsilon(p, sigma, mid, delta, orders) <= target_eps:
            lo = mid
        else:
            hi = mid
    return lo


def sigma_for_epsilon(
    p: float, steps: int, target_eps: float, delta: float,
    orders: Sequence[float] = DEFAULT_ORDERS,
    lo: float = 1e-2, hi: float = 1e3, tol: float = 1e-4,
) -> float:
    """Smallest noise multiplier achieving the target epsilon (bisection)."""
    if compute_epsilon(p, hi, steps, delta, orders) > target_eps:
        raise ValueError("target epsilon unreachable within sigma bound")
    while hi - lo > tol * max(1.0, lo):
        mid = 0.5 * (lo + hi)
        if compute_epsilon(p, mid, steps, delta, orders) <= target_eps:
            hi = mid
        else:
            lo = mid
    return hi


@dataclass
class RDPAccountant:
    """Stateful accountant tracking composition across DeCaPH rounds."""

    sampling_rate: float
    noise_multiplier: float
    delta: float
    orders: tuple[float, ...] = DEFAULT_ORDERS
    steps: int = 0
    _rdp: np.ndarray = field(default=None, repr=False)  # type: ignore[assignment]

    def __post_init__(self) -> None:
        self._per_step = compute_rdp_sgm(
            self.sampling_rate, self.noise_multiplier, 1, self.orders
        )
        self._rdp = np.zeros_like(self._per_step)

    def step(self, n: int = 1) -> None:
        self.steps += n
        self._rdp = self._rdp + n * self._per_step

    def epsilon(self) -> float:
        if self.steps == 0:
            return 0.0
        eps, _ = rdp_to_eps_delta(self._rdp, self.orders, self.delta)
        return eps

    def exceeds(self, budget: float) -> bool:
        return self.epsilon() > budget
