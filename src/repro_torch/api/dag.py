"""Declarative NT-DAG builder: the tenant-facing analogue of SuperNIC's
user interface (§3).

A tenant describes a network-task DAG with two operators and one constructor::

    from repro_torch.api import nt

    vpc   = nt("firewall") >> nt("nat") >> nt("chacha20")     # chain
    forked = nt("parse") >> (nt("fw") | nt("dedup")) >> nt("tx")  # fork/join

``>>`` sequences work; ``|`` forks a stage into parallel branches that join
in the synchronization buffer before the next stage.  Plain strings coerce,
so ``nt("a") >> "b"`` works too.

``compile_dag`` lowers an expression to the scheduler's :class:`NTDag`
stage tuples (``stages[i]`` = tuple of parallel branches; branch = tuple of
NT names) and validates NT names and areas against registered
:class:`NTSpec`s *at build time* — deploy-time surprises become build-time
errors.
"""
from __future__ import annotations

from repro_torch.core.nt import NTDag, NTSpec

Stages = tuple[tuple[tuple[str, ...], ...], ...]


class DagError(ValueError):
    """A DAG expression is malformed or fails spec validation."""


class DagExpr:
    """An immutable network-task DAG expression.

    Internally stored in the scheduler's normal form: a tuple of stages,
    each stage a tuple of parallel branches, each branch a tuple of NT
    names.  ``nt()`` makes leaves; ``>>`` and ``|`` compose.
    """

    __slots__ = ("stages",)

    def __init__(self, stages: Stages):
        object.__setattr__(self, "stages", tuple(
            tuple(tuple(b) for b in stage) for stage in stages))

    def __setattr__(self, *_):
        raise AttributeError("DagExpr is immutable")

    # ------------------------------------------------------------ operators --
    def __rshift__(self, other) -> "DagExpr":
        """Sequential composition.  Two adjacent single-branch stages fuse
        into one NT chain (one scheduler visit, §4.2); anything else becomes
        a stage boundary (a trip through the sync buffer)."""
        other = _coerce(other)
        a, b = self.stages, other.stages
        if len(a[-1]) == 1 and len(b[0]) == 1:
            fused = (a[-1][0] + b[0][0],)
            return DagExpr(a[:-1] + (fused,) + b[1:])
        return DagExpr(a + b)

    def __rrshift__(self, other) -> "DagExpr":
        return _coerce(other).__rshift__(self)

    def __or__(self, other) -> "DagExpr":
        """Parallel composition: both sides become branches of one stage.

        Branches are linear NT chains in the data model (§3), so each side
        must be a single stage; nest ``>>`` inside a branch, not ``|``
        around a multi-stage expression."""
        other = _coerce(other)
        for side in (self, other):
            if len(side.stages) != 1:
                raise DagError(
                    "parallel branches must be linear NT chains; "
                    f"{side!r} spans {len(side.stages)} stages — "
                    "fork/join nesting is not representable in an NTDag")
        return DagExpr((self.stages[0] + other.stages[0],))

    def __ror__(self, other) -> "DagExpr":
        return _coerce(other).__or__(self)

    # -------------------------------------------------------------- queries --
    def all_nts(self) -> list[str]:
        return [n for stage in self.stages for branch in stage
                for n in branch]

    def __repr__(self) -> str:
        def branch_s(b):
            return " >> ".join(b)
        return " >> ".join(
            branch_s(s[0]) if len(s) == 1 else
            "(" + " | ".join(branch_s(b) for b in s) + ")"
            for s in self.stages)

    def __eq__(self, other) -> bool:
        return isinstance(other, DagExpr) and self.stages == other.stages

    def __hash__(self) -> int:
        return hash(self.stages)


def nt(name: str) -> DagExpr:
    """A single-NT DAG expression (the builder's leaf)."""
    if not name or not isinstance(name, str):
        raise DagError(f"NT name must be a non-empty string, got {name!r}")
    return DagExpr((((name,),),))


def nt_chain(*names: str) -> DagExpr:
    """Chain a dynamic list of NT names: ``nt_chain("a", "b", "c")`` ==
    ``nt("a") >> nt("b") >> nt("c")``."""
    if not names:
        raise DagError("nt_chain needs at least one NT name")
    return DagExpr(((tuple(names),),))


def _coerce(x) -> DagExpr:
    if isinstance(x, DagExpr):
        return x
    if isinstance(x, str):
        return nt(x)
    raise DagError(f"cannot use {type(x).__name__} in a DAG expression; "
                   "wrap NT names with nt(...)")


def validate_dag(expr: DagExpr, specs: dict[str, NTSpec] | None,
                 region_slots: int | None = None) -> None:
    """Build-time checks: every NT is a registered spec, and every NT fits a
    region (a branch may split into sub-chains across regions, §4.3, but a
    single NT that exceeds ``region_slots`` can never be placed)."""
    if specs is not None:
        unknown = sorted(set(expr.all_nts()) - set(specs))
        if unknown:
            raise DagError(
                f"unknown NT(s) {unknown}; registered: {sorted(specs)}")
        if region_slots is not None:
            for name in expr.all_nts():
                if specs[name].area > region_slots:
                    raise DagError(
                        f"NT {name!r} needs area {specs[name].area} but a "
                        f"region has only {region_slots} slots")
    for stage in expr.stages:
        for branch in stage:
            if len(branch) != len(set(branch)):
                dup = sorted({n for n in branch
                              if branch.count(n) > 1})
                raise DagError(
                    f"branch {branch} repeats NT(s) {dup}; a chain program "
                    "instantiates each NT once per region")


def compile_dag(expr, uid: int, tenant: str,
                specs: dict[str, NTSpec] | None = None,
                region_slots: int | None = None) -> NTDag:
    """Lower a builder expression (or pass through an NTDag) to the exact
    ``NTDag.stages`` tuples the scheduler consumes."""
    if isinstance(expr, NTDag):
        return NTDag(uid, tenant, expr.stages)
    expr = _coerce(expr)
    validate_dag(expr, specs, region_slots)
    return NTDag(uid=uid, tenant=tenant, stages=expr.stages)
