"""Robust cost weights and GNC schedule.

Counterpart of ``dcora_tpu.core.robust``: numpy and scipy on the host, as
there.

reference: DCORA_robust.cpp:56-137 (weight functions per cost type; GNC-TLS
weight implements eq. (14) of the GNC paper), DCORA_robust.cpp:139-148
(chi-squared error quantile).
"""

from __future__ import annotations

import numpy as np

from dcora_tpu_torch.types import RobustCostParameters, RobustCostType


class RobustCost:
    def __init__(self, params: RobustCostParameters):
        self.params = params
        self.mu = params.GNCInitMu
        self._gnc_iteration = 0

    def reset(self):
        self.mu = self.params.GNCInitMu
        self._gnc_iteration = 0

    def weight(self, r):
        """Weight(s) for residual(s) r (scalar or ndarray)."""
        r = np.asarray(r, dtype=np.float64)
        p = self.params
        ct = p.costType
        if ct == RobustCostType.L2:
            return np.ones_like(r)
        if ct == RobustCostType.L1:
            return 1.0 / r
        if ct == RobustCostType.Huber:
            return np.where(r < p.HuberThreshold, 1.0, p.HuberThreshold / r)
        if ct == RobustCostType.TLS:
            return np.where(r < p.TLSThreshold, 1.0, 0.0)
        if ct == RobustCostType.GM:
            a = 1.0 + r * r
            return 1.0 / (a * a)
        if ct == RobustCostType.GNC_TLS:
            r_sq = r * r
            barc_sq = p.GNCBarc * p.GNCBarc
            mu = self.mu
            upper = (mu + 1) / mu * barc_sq
            lower = mu / (mu + 1) * barc_sq
            mid = np.sqrt(
                barc_sq * mu * (mu + 1) / np.where(r_sq == 0, 1.0, r_sq)
            ) - mu
            return np.where(r_sq >= upper, 0.0,
                            np.where(r_sq <= lower, 1.0, mid))
        raise NotImplementedError(ct)

    def update(self):
        """mu <- GNCMuStep * mu (reference: DCORA_robust.cpp:118-137)."""
        if self.params.costType != RobustCostType.GNC_TLS:
            return
        self._gnc_iteration += 1
        if self._gnc_iteration > self.params.GNCMaxNumIters:
            return
        self.mu = self.params.GNCMuStep * self.mu

    @staticmethod
    def compute_error_threshold_at_quantile(quantile: float,
                                            dimension: int) -> float:
        """sqrt(chi2inv(q, dof)) with dof = SE(d) degrees of freedom.

        The reference hard-codes dof=6 and CHECKs dimension==3
        (DCORA_robust.cpp:139-148); we extend to 2D (dof=3) rather than
        crash, since the 2D datasets are otherwise fully supported."""
        assert dimension in (2, 3), "dimension must be 2 or 3"
        assert quantile > 0
        dof = 6 if dimension == 3 else 3
        if quantile < 1:
            return float(np.sqrt(chi2inv(quantile, dof)))
        return 1e5


def chi2inv(quantile: float, dof: int) -> float:
    """Inverse chi-squared CDF through the inverse regularized lower gamma
    function (scipy.special.gammaincinv)."""
    from scipy.special import gammaincinv

    return 2.0 * float(gammaincinv(dof / 2.0, quantile))
