"""Diagnostic records for the pre-flight static analyzer.

Each finding carries a STABLE code (``PW-Xnnn``) so CI gates, dashboards
and strict mode can match on it without parsing prose.

This module is the SINGLE SOURCE OF TRUTH for the code registry:
:data:`CODE_INFO` maps every code to its fixed severity and one-line
description, :data:`CODES` is derived from it, and
:func:`render_code_table` generates the human-readable table that the
module docstring (below) and any docs embed — so the registry and the
prose can never drift apart.  The rows of the PW-J codes are the
port's own (the device pass, ``analysis/device.py``, reads PyTorch
source); every other row is the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

SEV_ERROR = "error"
SEV_WARNING = "warning"
SEV_INFO = "info"

_SEV_ORDER = {SEV_ERROR: 0, SEV_WARNING: 1, SEV_INFO: 2}

#: every code the analyzer can emit: code -> (fixed severity, description)
CODE_INFO: dict[str, tuple[str, str]] = {
    "PW-T001": (
        SEV_ERROR,
        "type mismatch (join keys, concat columns, or a declared column "
        "dtype the bytecode contradicts)",
    ),
    "PW-P001": (
        SEV_WARNING,
        "CALL_PY fallback in a program on a streaming (hot) path — the "
        "row loop drops off the native VM",
    ),
    "PW-S001": (
        SEV_WARNING,
        "unwindowed join/groupby over a streaming source: operator state "
        "grows without bound",
    ),
    "PW-S002": (
        SEV_ERROR,
        "append-only violation: an operator that requires append-only "
        "input is fed retractions",
    ),
    "PW-D001": (
        SEV_WARNING,
        "dead column: computed by a select but never read by any "
        "downstream consumer",
    ),
    "PW-N001": (
        SEV_WARNING,
        "nullability leak: an optionally-None value flows into a column "
        "declared non-optional at a sink-reaching select",
    ),
    "PW-X001": (
        SEV_ERROR,
        "order-sensitive stateful operator (keyed upsert into an index, "
        "deduplicate, asof join) fed by a partitioned source that does "
        "not preserve cross-rank per-key arrival order",
    ),
    "PW-X002": (
        SEV_WARNING,
        "join/groupby whose inputs are not co-partitioned with its keys: "
        "a full exchange of the hot streaming path",
    ),
    "PW-X003": (
        SEV_ERROR,
        "arrival-order-dependent reducer over a non-deterministically "
        "ordered stream feeding a sink: recovered runs are not "
        "byte-identical",
    ),
    "PW-R001": (
        SEV_ERROR,
        "stateful operator with out-of-band state but no "
        "snapshot_state/on_restore coverage: a checkpoint-coverage hole "
        "that duplicates work on replay",
    ),
    "PW-R002": (
        SEV_WARNING,
        "single-owner stateful serving/index node with no snapshot-backed "
        "standby: one rank's death takes the whole query surface down "
        "until recovery completes (an availability hole degraded serving "
        "cannot cover)",
    ),
    "PW-M001": (
        SEV_ERROR,
        "linear-in-stream operator state on an unbounded streaming path "
        "that reaches a sink: memory use grows with every row ingested, "
        "so the deployment dies by OOM schedule, not by load",
    ),
    "PW-M002": (
        SEV_WARNING,
        "estimated steady-state footprint exceeds PATHWAY_MEMORY_BUDGET "
        "(per-operator breakdown in details): provision more memory, "
        "shard wider, or bound retention",
    ),
    "PW-M003": (
        SEV_WARNING,
        "checkpoint bytes grow with stream length (stream-linear state is "
        "snapshotted): recovery-time targets degrade as the run ages",
    ),
    "PW-J001": (
        SEV_ERROR,
        "unbounded compiled-signature space on a hot path: a "
        "torch.compile'd callable (or a captured CUDA graph) fed unpadded "
        "batch sizes recompiles for every new size (pad to power-of-two "
        "buckets, ops.bucketing.bucket_size); the port uses neither "
        "today, so no site emits it",
    ),
    "PW-J002": (
        SEV_WARNING,
        "host<->device transfer (.item()/.cpu()/.tolist() readback, "
        "torch.cuda.synchronize, an upload of a parameter by "
        "torch.as_tensor/.to(device)/.cuda()) inside a per-query or "
        "per-epoch loop: the hot path stalls on PCIe every iteration",
    ),
    "PW-J003": (
        SEV_WARNING,
        "out-of-place update of a held device buffer assigned back over it "
        "(index_copy, scatter, torch.where, ...): the old and the new "
        "buffer are live together, doubling the card's peak where the JAX "
        "package donates the buffer to its scatter",
    ),
    "PW-J004": (
        SEV_ERROR,
        "collective divergence: a torch.distributed collective or the "
        "mesh's cross-card copy is reachable under rank-dependent Python "
        "control flow, so processes disagree about entering it and the "
        "group deadlocks",
    ),
    "PW-J005": (
        SEV_WARNING,
        "blocking device sync (torch.cuda.synchronize, a stream or event "
        "synchronize, .item()/.cpu()/.tolist() readback) inside an SLO "
        "lane or while holding an index lock: one device round trip "
        "serializes every waiter behind it",
    ),
}

#: every code the analyzer can emit, with its fixed severity (derived —
#: do not edit; add codes to CODE_INFO above)
CODES: dict[str, str] = {code: sev for code, (sev, _) in CODE_INFO.items()}


def render_code_table() -> str:
    """The registry as an aligned text table — generated, never
    hand-maintained.  Docs and docstrings embed this."""
    rows = [(code, sev, desc) for code, (sev, desc) in CODE_INFO.items()]
    lines = ["code        severity  meaning", "-" * 72]
    for code, sev, desc in rows:
        lines.append(f"{code:<11} {sev:<9} {desc}")
    return "\n".join(lines)


# the docstring advertises the registry it documents
__doc__ = (__doc__ or "") + "\n\n" + render_code_table() + "\n"


@dataclass(frozen=True)
class Diagnostic:
    """One static-analysis finding (reference: the Rust engine's
    build-time ``DataError``/trace plumbing, surfaced here as data
    instead of an exception so callers can batch and filter)."""

    code: str
    severity: str
    message: str
    #: user file:line that created the offending operator (Node.trace)
    trace: str = ""
    node_id: int | None = None
    node_name: str = ""
    #: free-form extras (column name, dtypes involved, ...)
    details: dict[str, Any] = field(default_factory=dict)

    def format(self) -> str:
        loc = f" at {self.trace}" if self.trace else ""
        op = f" [{self.node_name}#{self.node_id}]" if self.node_id is not None else ""
        return f"{self.code} {self.severity}: {self.message}{op}{loc}"


class AnalysisError(RuntimeError):
    """Raised by ``run(strict=True)`` when error-severity findings exist.

    Carries the full diagnostic list in ``.diagnostics``."""

    def __init__(self, diagnostics: list[Diagnostic]):
        self.diagnostics = list(diagnostics)
        errors = [d for d in self.diagnostics if d.severity == SEV_ERROR]
        lines = "\n".join("  " + d.format() for d in errors)
        super().__init__(
            f"static analysis found {len(errors)} error-severity "
            f"finding(s); refusing to run (strict mode):\n{lines}"
        )


def sort_diagnostics(diags: list[Diagnostic]) -> list[Diagnostic]:
    """Severity-major, then graph order — stable for tests and CLI."""
    return sorted(
        diags,
        key=lambda d: (
            _SEV_ORDER.get(d.severity, 9),
            d.code,
            d.node_id if d.node_id is not None else 1 << 30,
        ),
    )


def format_diagnostics(diags: list[Diagnostic]) -> str:
    return "\n".join(d.format() for d in diags)


def count_by_severity(diags: list[Diagnostic]) -> dict[str, int]:
    out = {SEV_ERROR: 0, SEV_WARNING: 0, SEV_INFO: 0}
    for d in diags:
        out[d.severity] = out.get(d.severity, 0) + 1
    return out
