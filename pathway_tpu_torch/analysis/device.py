"""Device-safety pass (A11): transfer, sync and collective hazards of the
PyTorch device plane, priced pre-run.

The fourth analyzer.  PW-T reasons about types, PW-X about placement,
PW-M about bytes; none of them sees a ``.item()``, a ``.to(device)`` or a
cross-card copy, yet a card serves fast only while the host hands it work
without waiting on it.  This pass walks the *source* of the device modules
(an AST abstract interpretation, not the dataflow graph: host/device
boundaries are a Python-level construct the engine graph cannot
represent) and emits registry-backed codes through the same surfaces as
every other pass:

- PW-J001 (error, unbounded compiled-signature space) has no check: the
  port compiles nothing (``torch.compile``) and captures no CUDA graph.
- PW-J002 (warning): a host<->device transfer inside a per-query or
  per-epoch loop of a hot function: a readback (``.item()``, ``.cpu()``,
  ``.tolist()``), ``torch.cuda.synchronize()``, or an upload of a
  parameter (``torch.as_tensor(p, device=...)``, ``p.to(device)``,
  ``p.cuda()``).  A copy with ``non_blocking=True`` is the cure, not the
  disease, and is not flagged.
- PW-J003 (warning): an out-of-place update of a buffer that an object
  holds, assigned back over it (``self.slab = self.slab.index_copy(...)``,
  ``.scatter``, ``.index_put``, ``.masked_fill``, ``torch.where(m, new,
  self.slab)``, ...):
  the old and the new buffer are live together, doubling the card's peak
  where the JAX package donates the buffer to its scatter
  (``parallel/sharded_knn.py``'s ``_scatter_set_device``; the port writes
  the slab in place with K2 or ``index_copy_``).
- PW-J004 (error): a collective (``torch.distributed.*``, or the mesh's
  cross-card hand-on of ``ops/ring_attention.py``) reachable under
  rank-dependent Python control flow (``*rank*``, ``process_index``):
  processes disagree about entering the collective and the group
  deadlocks.  Branching on static config is fine.
- PW-J005 (warning): a blocking sync (``torch.cuda.synchronize``, a
  stream's or event's ``.synchronize()``, ``.item()``, ``.cpu()``,
  ``.tolist()``) while a lock is held, or inside an SLO lane body (the
  host lanes of :data:`_LANES`): one device round trip serializes every
  waiter behind it.

Heuristics are precise by default (they would rather miss a finding than
make one up): cold paths (train/grow/init/restore/checkpoint/...) are not
flagged for J002 and J003, and a ``# pw-j:`` (or code-specific ``# pw-j002:``)
comment on the offending line waives a finding with an audit trail.

``check_device`` bridges the file analysis into ``pw.analyze()``: it scans
the modules *reachable from the graph* (the defining module of an index
node's adapter; the whole device surface when a node's ``meta`` marks a
serving stage or an index upsert), attributing findings to those nodes,
and prices the device-resident state per card against
``PATHWAY_DEVICE_BUDGET_BYTES`` (PW-M002 with a device scope).
"""

from __future__ import annotations

import ast
import dataclasses
import glob
import os
import sys
from dataclasses import dataclass
from typing import Any, Iterable

from pathway_tpu_torch.analysis.diagnostics import SEV_ERROR, SEV_WARNING, Diagnostic
from pathway_tpu_torch.analysis.graph_facts import GraphFacts

__all__ = [
    "DeviceReport",
    "scan_source",
    "scan_file",
    "scan_paths",
    "device_module_files",
    "device_profile",
    "check_device",
]

#: substrings that mark a function as cold-path (one-time / amortized):
#: recompiles and transfers there are expected and irrelevant
_COLD_TOKENS = (
    "train",
    "kmeans",
    "grow",
    "init",
    "restore",
    "state",  # state_dict / load_state_dict
    "convert",
    "checkpoint",
    "snapshot",
    "warm",
    "load",
    "setup",
    "save",
    "rebuild",
    "close",
    "shutdown",
    "teardown",
)

#: torch.distributed collectives (called through the module or its alias)
_COLLECTIVES = {
    "all_reduce",
    "all_gather",
    "all_gather_into_tensor",
    "all_gather_object",
    "reduce_scatter",
    "reduce_scatter_tensor",
    "all_to_all",
    "all_to_all_single",
    "broadcast",
    "broadcast_object_list",
    "barrier",
    "reduce",
    "gather",
    "scatter",
    "send",
    "recv",
    "isend",
    "irecv",
}

#: the mesh's cross-card copies: the ring's hand-on of a key/value block
#: to the next card (``ops/ring_attention.py``)
_MESH_COPIES = {"_hand_on", "ring_attention_blocks"}

#: identity tokens whose appearance in a branch condition makes control
#: flow rank-data-dependent (lowercase substring match)
_RANK_TOKENS = ("rank", "process_index", "process_id", "proc_id")

#: zero-argument tensor methods that read a value back to the host
_READBACKS = ("item", "cpu", "tolist")

#: out-of-place tensor updates whose in-place twin ends in ``_``
_OUT_OF_PLACE = {
    "index_copy",
    "index_put",
    "index_add",
    "index_fill",
    "scatter",
    "scatter_add",
    "scatter_reduce",
    "masked_fill",
    "masked_scatter",
    "put",
}

#: the host lanes a served question passes through, by (module path under
#: the package, qualified function name): a blocking sync in their body
#: holds every request behind it
_LANES = {
    ("engine/external_index.py", "ExternalIndexNode._answer"),
    ("stdlib/indexing/segments.py", "SegmentedIndex.dispatch"),
    ("stdlib/indexing/segments.py", "SegmentedIndex._merge_inplace"),
    ("io/http/__init__.py", "PathwayWebserver._dispatch"),
    # the serving stages that run inside ``SloScheduler._execute``, on the
    # scheduler's one dispatcher thread (the JAX pass treats every
    # ``*lane*`` function of ``serving/`` so)
    ("serving/coscheduler.py", "StageCoScheduler._embed_batch"),
    ("serving/coscheduler.py", "StageCoScheduler._retrieve"),
    ("serving/graph.py", "RagServingApp._ingest_batch"),
}

#: the device surface beyond ``ops/``, ``models/``, ``parallel/`` and
#: ``kernels/``: the trainer and the modules of the lanes above
_DEVICE_FILES = ("train.py",) + tuple(sorted({path for path, _ in _LANES}))


def _fname(node: ast.AST) -> str:
    """Final identifier of a Name/Attribute chain ('' otherwise)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _dotted(node: ast.AST) -> str:
    """``a.b.c`` of a Name/Attribute chain ('' otherwise)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return ""
    parts.append(node.id)
    return ".".join(reversed(parts))


def _cold(name: str) -> bool:
    low = name.lower()
    return any(tok in low for tok in _COLD_TOKENS)


def _rank_dependent(test: ast.AST) -> bool:
    for sub in ast.walk(test):
        ident = ""
        if isinstance(sub, ast.Name):
            ident = sub.id
        elif isinstance(sub, ast.Attribute):
            ident = sub.attr
        elif isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            ident = sub.value
        if ident and any(tok in ident.lower() for tok in _RANK_TOKENS):
            return True
    return False


def _waived(lines: "list[str]", lineno: int, code: str) -> bool:
    if not (1 <= lineno <= len(lines)):
        return False
    src = lines[lineno - 1].lower()
    return "pw-j:" in src or f"pw-j{code[-3:]}:" in src


def _non_blocking(call: ast.Call) -> bool:
    return any(
        kw.arg == "non_blocking"
        and not (isinstance(kw.value, ast.Constant) and not kw.value.value)
        for kw in call.keywords
    )


class _ModuleIndex:
    """Module-level facts: which functions hold collectives, how
    ``torch.distributed`` is spelled here, whether torch is imported."""

    def __init__(self, tree: ast.Module):
        self.collective_fns: set[str] = set()
        self.dist_aliases: set[str] = {"torch.distributed"}
        self.dist_names: set[str] = set()
        self.has_torch = False

        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name.split(".")[0] == "torch":
                        self.has_torch = True
                    if alias.name == "torch.distributed" and alias.asname:
                        self.dist_aliases.add(alias.asname)
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if mod.split(".")[0] == "torch":
                    self.has_torch = True
                for alias in node.names:
                    if mod == "torch" and alias.name == "distributed":
                        self.dist_aliases.add(alias.asname or "distributed")
                    elif mod == "torch.distributed" and alias.name in _COLLECTIVES:
                        self.dist_names.add(alias.asname or alias.name)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if any(
                    isinstance(sub, ast.Call) and self.collective_name(sub)
                    for sub in ast.walk(node)
                ):
                    self.collective_fns.add(node.name)

    def collective_name(self, call: ast.Call) -> str:
        """The collective this Call enters ('' if none)."""
        func = call.func
        name = _fname(func)
        if isinstance(func, ast.Attribute) and name in _COLLECTIVES:
            if _dotted(func.value) in self.dist_aliases:
                return name
        if isinstance(func, ast.Name) and name in self.dist_names:
            return name
        if name in _MESH_COPIES:
            return name
        return ""


def _mentions(node: ast.AST, names: set) -> bool:
    return any(isinstance(sub, ast.Name) and sub.id in names for sub in ast.walk(node))


def _devicey(node: ast.AST) -> bool:
    """An argument that names a device: ``device``, ``dev``, ``self.device``,
    ``torch.device(...)``, ``"cuda"``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.startswith("cuda")
    if isinstance(node, ast.Call):
        return _dotted(node.func) == "torch.device"
    name = _fname(node).lower()
    return name in ("dev", "device", "cuda") or name.endswith("_device") or name.endswith("_dev")


def _upload_of_param(call: ast.Call, params: set) -> "str | None":
    """This Call uploads (part of) a parameter to the card:
    ``torch.as_tensor(p, device=...)``, ``p.to(device)``, ``p.cuda()``."""
    if _non_blocking(call):
        return None
    func = call.func
    dotted = _dotted(func)
    if dotted in ("torch.as_tensor", "torch.tensor", "torch.from_numpy"):
        if any(kw.arg == "device" for kw in call.keywords) and any(
            _mentions(a, params) for a in call.args
        ):
            return dotted
        return None
    if not isinstance(func, ast.Attribute) or not _mentions(func.value, params):
        return None
    if func.attr == "cuda":
        return ".cuda()"
    if func.attr == "to" and (
        any(_devicey(a) for a in call.args)
        or any(kw.arg == "device" for kw in call.keywords)
    ):
        return ".to(device)"
    return None


def _sync_call(call: ast.Call, idx: _ModuleIndex) -> "str | None":
    """A call that waits for the card: a readback (``.item()``, ``.cpu()``,
    ``.tolist()``) in a module that uses torch, or a synchronize."""
    func = call.func
    if not isinstance(func, ast.Attribute):
        return None
    if func.attr == "synchronize" and not call.args:
        return "torch.cuda.synchronize" if _dotted(func) == "torch.cuda.synchronize" else ".synchronize()"
    if func.attr in _READBACKS and not call.args and idx.has_torch and not _non_blocking(call):
        return f".{func.attr}()"
    return None


def _locky(expr: ast.AST) -> bool:
    name = _fname(expr).lower()
    if isinstance(expr, ast.Call):
        name = _fname(expr.func).lower()
    return any(tok in name for tok in ("lock", "mutex", "_mu", "cond", "cv"))


def _arg_names(fn: "ast.FunctionDef | ast.AsyncFunctionDef") -> set:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return set(names) - {"self", "cls"}


def _held(target: ast.AST) -> bool:
    """A target that an object holds (``self.slab``, ``self._vecs[s]``):
    a buffer that outlives the call, as a slab does; a local temporary
    is not one."""
    while isinstance(target, ast.Subscript):
        target = target.value
    return isinstance(target, ast.Attribute)


def _out_of_place_update(stmt: ast.AST) -> "str | None":
    """``self.slab = self.slab.index_copy(...)`` / ``self.slab =
    torch.where(m, new, self.slab)``: an out-of-place update of a held
    buffer assigned back over it."""
    if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
        target = stmt.targets[0]
    elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
        target = stmt.target
    else:
        return None
    value = stmt.value
    if not isinstance(value, ast.Call) or not _held(target):
        return None
    want = ast.dump(target, annotate_fields=False).replace("Store()", "Load()")
    func = value.func
    if isinstance(func, ast.Attribute) and func.attr in _OUT_OF_PLACE:
        if ast.dump(func.value, annotate_fields=False) == want:
            return func.attr
    if _dotted(func) == "torch.where" and len(value.args) == 3:
        if ast.dump(value.args[2], annotate_fields=False) == want:
            return "torch.where"
    return None


class _FunctionScan:
    """One hot/cold-classified function body walked with loop / branch /
    lock context stacks."""

    def __init__(
        self,
        fn: "ast.FunctionDef | ast.AsyncFunctionDef",
        qualname: str,
        cold: bool,
        idx: _ModuleIndex,
        lines: "list[str]",
        filename: str,
        lane: bool,
    ):
        self.fn = fn
        self.qualname = qualname
        self.cold = cold
        self.idx = idx
        self.lines = lines
        self.filename = filename
        self.lane = lane
        self.diags: list[Diagnostic] = []
        self.params = _arg_names(fn)

    def _emit(self, code: str, sev: str, lineno: int, message: str, **details: Any) -> None:
        if _waived(self.lines, lineno, code):
            return
        self.diags.append(
            Diagnostic(
                code=code,
                severity=sev,
                message=message,
                trace=f"{self.filename}:{lineno}",
                node_name=self.qualname,
                details=dict(details, file=self.filename, line=lineno),
            )
        )

    def run(self) -> "list[Diagnostic]":
        self._visit(self.fn, loop=0, conds=(), locks=0)
        return self.diags

    # ------------------------------------------------------------------
    def _visit(self, node: ast.AST, loop: int, conds: tuple, locks: int) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue  # nested defs get their own scan
            c_loop, c_conds, c_locks = loop, conds, locks
            if isinstance(child, (ast.For, ast.AsyncFor)):
                # a comprehension is one batched staging step, as in the
                # JAX package's pass, not a per-iteration stall
                c_loop = loop + 1
            elif isinstance(child, ast.While):
                c_loop = loop + 1
                c_conds = conds + (child.test,)
            elif isinstance(child, (ast.If, ast.IfExp)):
                c_conds = conds + (child.test,)
            elif isinstance(child, (ast.With, ast.AsyncWith)):
                if any(_locky(item.context_expr) for item in child.items):
                    c_locks = locks + 1
            if isinstance(child, ast.Call):
                self._check_call(child, c_loop, c_conds, c_locks)
            elif not self.cold:
                self._check_update(child)
            self._visit(child, c_loop, c_conds, c_locks)

    def _check_update(self, stmt: ast.AST) -> None:
        # PW-J003: an out-of-place update assigned back over its buffer
        op = _out_of_place_update(stmt)
        if op is None:
            return
        self._emit(
            "PW-J003",
            SEV_WARNING,
            stmt.lineno,
            f"out-of-place device-buffer update ({op}) assigned back over "
            "the buffer: the old and the new buffer are live together, "
            "doubling the card's peak where the JAX package donates it — "
            f"update in place ({op}_ or a kernel that writes the slab)",
            op=op,
            function=self.qualname,
        )

    def _check_call(self, call: ast.Call, loop: int, conds: tuple, locks: int) -> None:
        idx = self.idx
        # PW-J004: collectives under rank-dependent control flow (checked
        # even on cold paths: a deadlock at init hangs the group too)
        name = idx.collective_name(call) or (
            _fname(call.func) if _fname(call.func) in idx.collective_fns else ""
        )
        if name and any(_rank_dependent(t) for t in conds):
            self._emit(
                "PW-J004",
                SEV_ERROR,
                call.lineno,
                f"collective or cross-card copy ({name}) reachable under "
                "rank-dependent control flow: processes can disagree about "
                "entering it and the group deadlocks — hoist the branch "
                "out or make it rank-invariant",
                collective=name,
                function=self.qualname,
            )

        # PW-J005: blocking sync while holding a lock / in an SLO lane
        sync = _sync_call(call, idx)
        if sync and (locks > 0 or self.lane):
            where = "while holding a lock" if locks > 0 else "inside an SLO serving lane"
            self._emit(
                "PW-J005",
                SEV_WARNING,
                call.lineno,
                f"blocking device sync ({sync}) {where}: every waiter "
                "serializes behind one device round trip — move the sync "
                "outside the critical section, or copy with "
                "non_blocking=True and wait on an event",
                sync=sync,
                function=self.qualname,
            )

        if self.cold:
            return

        # PW-J002: a transfer or sync inside a hot loop
        if loop > 0:
            transfer = sync or _upload_of_param(call, self.params)
            if transfer:
                self._emit(
                    "PW-J002",
                    SEV_WARNING,
                    call.lineno,
                    f"host<->device transfer ({transfer}) inside a "
                    "per-iteration loop of a hot function: the loop waits "
                    "on the host link every pass — batch the transfer "
                    "outside the loop or copy with non_blocking=True",
                    transfer=transfer,
                    function=self.qualname,
                )


def _iter_functions(
    tree: ast.Module,
) -> "Iterable[tuple[ast.FunctionDef | ast.AsyncFunctionDef, str, bool]]":
    """(fn, qualname, cold) for every def, nested defs inheriting the
    enclosing function's coldness (a hot helper inside _kmeans is cold)."""

    def walk(body, prefix, inherited_cold):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{node.name}" if prefix else node.name
                cold = inherited_cold or _cold(node.name)
                yield node, qual, cold
                yield from walk(node.body, qual + ".", cold)
            elif isinstance(node, ast.ClassDef):
                yield from walk(node.body, f"{prefix}{node.name}.", inherited_cold)

    yield from walk(tree.body, "", False)


def _lane(filename: str, qualname: str) -> bool:
    path = filename.replace(os.sep, "/")
    return any(path.endswith(mod) and qualname == qual for mod, qual in _LANES)


def scan_source(source: str, filename: str = "<string>") -> "list[Diagnostic]":
    """Run all PW-J checks over one module's source.  Returns findings;
    raises nothing (a syntax error yields no findings: the module will
    fail louder elsewhere)."""
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return []
    idx = _ModuleIndex(tree)
    lines = source.splitlines()
    out: list[Diagnostic] = []
    for fn, qual, cold in _iter_functions(tree):
        scan = _FunctionScan(fn, qual, cold, idx, lines, filename, _lane(filename, qual))
        out.extend(scan.run())
    return out


#: memoized per-file scans: path -> (mtime, size, findings)
_file_cache: dict[str, tuple[float, int, "list[Diagnostic]"]] = {}


def scan_file(path: str) -> "list[Diagnostic]":
    path = os.path.abspath(path)
    try:
        st = os.stat(path)
    except OSError:
        return []
    cached = _file_cache.get(path)
    if cached is not None and cached[0] == st.st_mtime and cached[1] == st.st_size:
        return list(cached[2])
    try:
        with open(path, encoding="utf-8") as f:
            source = f.read()
    except OSError:
        return []
    rel = path
    for root in (os.getcwd(), os.path.dirname(_package_dir())):
        if root and path.startswith(root + os.sep):
            rel = os.path.relpath(path, root)
            break
    findings = scan_source(source, rel)
    _file_cache[path] = (st.st_mtime, st.st_size, findings)
    return list(findings)


@dataclass(frozen=True)
class DeviceReport:
    """One device-safety sweep: files scanned + findings."""

    files: tuple
    diagnostics: tuple

    @property
    def by_code(self) -> dict:
        out: dict[str, int] = {}
        for d in self.diagnostics:
            out[d.code] = out.get(d.code, 0) + 1
        return out

    @property
    def predicted_recompile_sites(self) -> int:
        return self.by_code.get("PW-J001", 0)

    @property
    def errors(self) -> int:
        return sum(1 for d in self.diagnostics if d.severity == SEV_ERROR)


def scan_paths(paths: "Iterable[str]") -> DeviceReport:
    files = []
    diags: list[Diagnostic] = []
    for p in paths:
        p = os.path.abspath(p)
        if p in files:
            continue
        files.append(p)
        diags.extend(scan_file(p))
    return DeviceReport(files=tuple(files), diagnostics=tuple(diags))


def _package_dir() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def device_module_files() -> "list[str]":
    """The port's device surface: ``ops/``, ``models/``, ``parallel/``,
    ``kernels/*.py``, ``serving/``, ``train.py``, and the modules of the
    host lanes a served question passes through (:data:`_LANES`)."""
    pkg = _package_dir()
    out: list[str] = []
    for sub in ("ops", "models", "parallel", "kernels", "serving"):
        out.extend(sorted(glob.glob(os.path.join(pkg, sub, "*.py"))))
    out.extend(os.path.join(pkg, *f.split("/")) for f in _DEVICE_FILES)
    return [f for f in dict.fromkeys(out) if os.path.isfile(f)]


_profile_cache: "dict | None" = None


def device_profile(refresh: bool = False) -> dict:
    """Static prediction for the ``/status`` join: scan the device surface
    once per process and summarize."""
    global _profile_cache
    if _profile_cache is not None and not refresh:
        return dict(_profile_cache)
    report = scan_paths(device_module_files())
    _profile_cache = {
        "files_scanned": len(report.files),
        "findings": sum(report.by_code.values()),
        "errors": report.errors,
        "by_code": report.by_code,
        "predicted_recompile_sites": report.predicted_recompile_sites,
    }
    return dict(_profile_cache)


# ----------------------------------------------------------------------
# graph pass


def _module_file(obj: Any) -> "str | None":
    mod = sys.modules.get(type(obj).__module__)
    f = getattr(mod, "__file__", None)
    if not f:
        return None
    f = os.path.abspath(f)
    return f if f.startswith(_package_dir() + os.sep) else None


def _device_count() -> int:
    """Cards the device-resident state splits across:
    ``PATHWAY_DEVICE_CHIPS``, else ``torch.cuda.device_count()``, and 1
    with no card."""
    chips = int(os.environ.get("PATHWAY_DEVICE_CHIPS", "0") or 0)
    if chips > 0:
        return chips
    import torch

    return max(1, torch.cuda.device_count())


def _check_device_budget(graph: Any, facts: GraphFacts) -> "list[Diagnostic]":
    """PW-M002 with a per-card scope: the device-resident share of the
    estimated state, split across the cards (:func:`_device_count`), must
    fit PATHWAY_DEVICE_BUDGET_BYTES."""
    from pathway_tpu_torch.analysis.memory import (
        EstimateParams,
        build_report,
        parse_budget,
    )

    budget = parse_budget(os.environ.get("PATHWAY_DEVICE_BUDGET_BYTES"))
    if budget is None:
        return []
    chips = _device_count()
    report = build_report(graph, facts, params=EstimateParams.from_env())
    by_node = {n.id: n for n in graph.nodes}
    device_ops = []
    for op in report.operators:
        n = by_node.get(op.node_id)
        if n is None:
            continue
        meta = getattr(n, "meta", None) or {}
        devicey = bool(meta.get("index_upsert"))
        adapter = getattr(n, "adapter", None)
        if adapter is not None:
            mod = type(adapter).__module__
            if mod.startswith("pathway_tpu_torch.parallel") or ".indexing" in mod:
                devicey = True
        if devicey:
            device_ops.append(op)
    if not device_ops:
        return []
    dev_bytes = sum(op.per_worker_bytes for op in device_ops)
    per_chip = dev_bytes // chips
    if per_chip <= budget:
        return []
    breakdown = [
        (f"{op.name}#{op.node_id}", op.per_worker_bytes)
        for op in sorted(device_ops, key=lambda o: o.per_worker_bytes, reverse=True)[:8]
    ]
    return [
        Diagnostic(
            code="PW-M002",
            severity=SEV_WARNING,
            message=(
                f"estimated device-resident state {per_chip} B/chip "
                f"(total {dev_bytes} B across {chips} chip(s)) exceeds "
                f"PATHWAY_DEVICE_BUDGET_BYTES={budget} B: shard the "
                "index wider or spill cold cells to host"
            ),
            details={
                "scope": "device-per-chip",
                "budget_bytes": budget,
                "estimated_bytes": per_chip,
                "chips": chips,
                "breakdown": breakdown,
            },
        )
    ]


def check_device(graph: Any, facts: GraphFacts) -> "list[Diagnostic]":
    """The ``pw.analyze()`` bridge: scan the device modules reachable
    from this graph and attribute findings to the nodes that pull them
    in.  Host-only graphs (no index adapters, no serving or upsert
    annotations) scan nothing and return fast."""
    out: list[Diagnostic] = []
    try:
        out.extend(_check_device_budget(graph, facts))
    except Exception:
        pass  # budget pricing must never mask the source scan

    files: dict[str, tuple] = {}
    serving_anchor = None
    for n in graph.nodes:
        meta = getattr(n, "meta", None) or {}
        adapter = getattr(n, "adapter", None)
        if adapter is not None:
            f = _module_file(adapter)
            if f:
                files.setdefault(f, (n.id, type(adapter).__name__))
            if serving_anchor is None:
                serving_anchor = n  # an index node serves the device path
        if serving_anchor is None and (meta.get("serving") or meta.get("index_upsert")):
            serving_anchor = n
    if serving_anchor is not None:
        # a serving graph executes the whole device surface (encoder,
        # index, lanes); scan all of it, anchored to the serving node
        anchor = (serving_anchor.id, type(serving_anchor).__name__)
        for f in device_module_files():
            files.setdefault(os.path.abspath(f), anchor)

    for f in sorted(files):
        node_id, node_name = files[f]
        for d in scan_file(f):
            out.append(dataclasses.replace(d, node_id=node_id, node_name=node_name))
    return out
