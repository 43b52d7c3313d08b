"""repro_torch.analysis — the static-analysis plane for safe multi-tenant offload.

SuperNIC's promise is that tenants can "efficiently *and safely*" offload
network-task DAGs to shared hardware (§3); this package is the *safely*
part, the JAX package's three passes over one shared
:class:`~repro_torch.analysis.diagnostics.Diagnostic` record type:

  - **Admission verifier** (:mod:`repro_torch.analysis.verifier`): static checks
    run at ``Platform.deploy()`` time — structure (cycles, fork/join arity,
    unreachable stages, signature/shape compatibility along every edge),
    resource bounds (state bytes and each kernel's per-block shared-memory
    footprint vs the ``core.vmem`` budgets, chain bottleneck rate vs
    declared capacity), and
    isolation (no cross-tenant NT state unless the spec is ``shared``).
  - **Datapath linter** (:mod:`repro_torch.analysis.linter`): ast rules
    for PyTorch's host-side hazards — host syncs inside hot loops, host to
    device copies outside the dispatch ring, compiles and kernel builds in
    loops, nondeterminism in the event sim.
  - **Invariant harness** (:mod:`repro_torch.analysis.invariants`): opt-in
    (``REPRO_SANITIZE=1``) conservation checks run at epoch boundaries —
    credits granted == consumed + residual, batches injected == completed
    + queued + shed, WDRR deficits never negative.

CLI: ``python -m repro_torch.analysis {lint,hlo,typecheck} ...`` — see
:mod:`repro_torch.analysis.__main__`; :mod:`repro_torch.analysis.hlo`
holds the kernel-text and buffer tools that take the place of the HLO
tools on a CUDA build.  The lint gate's baseline is
``analysis_baseline_torch.json``.
"""
from .diagnostics import (Baseline, Diagnostic, Severity,  # noqa: F401
                          render_text)

__all__ = ["AdmissionError", "Baseline", "Diagnostic", "Severity",
           "render_text", "verify"]


def __getattr__(name):
    # verifier lazily: it imports repro_torch.api.dag, and the runtime hooks in
    # repro_torch.core/* import THIS package for the invariant harness — an eager
    # verifier import would close that cycle mid-initialization
    if name in ("AdmissionError", "verify"):
        from . import verifier
        return getattr(verifier, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
