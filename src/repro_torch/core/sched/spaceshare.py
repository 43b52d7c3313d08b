"""Epoch-driven DRF grants — fair space sharing.

Wraps the reusable :class:`repro_torch.core.policy.DRFAdmission` (measured-demand
accumulator + weighted-DRF solver) with the two grant-to-enforcement
conversions every substrate ends up needing:

  - **rates**: an ingress token-bucket rate per tenant (the sNIC enforces
    its whole allocation through one ingress throttle, §4.4);
  - **budgets**: a per-epoch admission budget in one resource's units (the
    serving engine admits requests against a token budget).

Keeping these here means a substrate's epoch loop is three lines: observe
arrivals as they happen, call :meth:`SpaceShare.epoch` with the capacity
vector, apply the returned rates/budgets.
"""
from __future__ import annotations

from ..drf import DRFResult
from ..policy import DRFAdmission


class SpaceShare:
    """Measured-demand DRF epoch loop with grant conversions."""

    def __init__(self, weights: dict[str, float] | None = None):
        self.admission = DRFAdmission(weights)

    @property
    def weights(self) -> dict[str, float]:
        return self.admission.weights

    def observe(self, tenant: str, resource: str, amount: float) -> None:
        """Record offered load — *before* any credit/budget gating (§4.4:
        "even if there is no credit, we still capture the intended load")."""
        self.admission.observe(tenant, resource, amount)

    def epoch(self, capacities: dict[str, float],
              extra: dict[str, dict[str, float]] | None = None,
              ) -> DRFResult | None:
        """Solve weighted DRF over the epoch's measured demand (+ ``extra``,
        typically standing backlog) and start the next window.  None when
        nothing was observed."""
        return self.admission.allocate(capacities, extra=extra)

    # ------------------------------------------------- grant conversions --
    @staticmethod
    def to_rates(res: DRFResult, resource: str, epoch_len: float,
                 headroom: float = 1.0, floor: float = 0.0,
                 ) -> dict[str, float]:
        """Per-tenant pacing rates (cost units / time unit) from one
        resource's grants.  ``headroom`` > 1 makes the limiter enforce
        *fairness* rather than admission — the physical resource is the
        real ceiling, and token-bucket quantization under bursty small
        items wastes throughput when the limiter is tight."""
        return {t: max(a.get(resource, 0.0) * headroom / epoch_len, floor)
                for t, a in res.alloc.items()}

    @staticmethod
    def budgets(res: DRFResult, resource: str) -> dict[str, float]:
        """Per-tenant admission budgets in ``resource`` units."""
        return {t: a.get(resource, 0.0) for t, a in res.alloc.items()}
