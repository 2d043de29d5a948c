"""Lower expression ASTs to native stack-VM bytecode.

The reference evaluates typed expression trees row-wise entirely in Rust
(``src/engine/expression.rs:26-491``) — no Python in the select/filter
hot loop.  This module is the TPU build's equivalent front half: it walks
the (build-time-typed) :mod:`pathway_tpu_torch.internals.expression` AST and
emits a flat postfix program for the C++ VM in
``native/pathway_native.cpp`` (``vm_eval_batch``/``vm_filter_batch``).

Lazy constructs (``if_else``/``coalesce``/``fill_error``/``get`` default)
compile to jump-based code so only the taken branch evaluates — the same
observable behaviour as the Python closures.  High-traffic
``.dt``/``.str``/``.num`` namespace methods lower to ``OP_METHOD`` with a
native implementation per method (reference evaluates these enums in Rust,
``src/engine/expression.rs:26-340``); subtrees with no native lowering
(UDF ``apply``, zoneinfo conversions) fall back to their
ordinary ``_compile`` closure, embedded as a single ``CALL_PY``
instruction; the rest of the expression still runs native.

Every op's behaviour is pinned to the Python closure semantics by the
differential tests in ``tests/test_expr_vm.py`` (native program vs pure
Python closure over a value matrix including ``None`` and ``ERROR``).
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as ex
from pathway_tpu_torch.internals import keys
from pathway_tpu_torch.internals import native as _native

# opcodes — must mirror enum VmOp in native/pathway_native.cpp
OP_LOAD_COL = 1
OP_LOAD_KEY = 2
OP_LOAD_CONST = 3
OP_CALL_PY = 4
OP_BIN = 5
OP_NEG = 6
OP_INV = 7
OP_IS_NONE = 8
OP_BRANCH = 9
OP_JUMP = 10
OP_JUMP_NOT_NONE = 11
OP_POP = 12
OP_REQUIRE = 13
OP_UNWRAP = 14
OP_FILL_JUMP = 15
OP_CAST = 16
OP_CONVERT = 17
OP_MAKE_TUPLE = 18
OP_GET = 19
OP_POINTER = 20
OP_METHOD = 21

# (method name, operand count) -> native method id — must mirror enum
# VmMethod in native/pathway_native.cpp.  str.split maps BOTH arities to
# one id — the native op distinguishes whitespace vs separator splitting
# by operand count.  to_utc / to_naive_in_timezone carry their zone's
# packed transition table (internals/tztable.py) as a constant operand,
# so the zoneinfo database is consulted at graph build, not per row.
_METHOD_IDS = {
    ("str.lower", 1): 0,
    ("str.upper", 1): 1,
    ("str.swapcase", 1): 2,
    ("str.title", 1): 3,
    ("str.reversed", 1): 4,
    ("str.len", 1): 5,
    ("str.strip", 1): 6,
    ("str.strip", 2): 6,
    ("str.lstrip", 1): 7,
    ("str.lstrip", 2): 7,
    ("str.rstrip", 1): 8,
    ("str.rstrip", 2): 8,
    ("str.count", 2): 9,
    ("str.find", 3): 10,
    ("str.find", 4): 10,
    ("str.rfind", 3): 11,
    ("str.rfind", 4): 11,
    ("str.startswith", 2): 12,
    ("str.endswith", 2): 13,
    ("str.replace", 4): 14,
    ("str.slice", 3): 15,
    ("str.parse_int", 1): 16,
    ("str.parse_int_opt", 1): 17,
    ("str.parse_float", 1): 18,
    ("str.parse_float_opt", 1): 19,
    ("str.parse_bool", 3): 20,
    ("str.parse_bool_opt", 3): 21,
    ("str.parse_datetime", 2): 22,
    ("dt.strptime", 2): 22,
    ("dt.nanosecond", 1): 23,
    ("dt.microsecond", 1): 24,
    ("dt.millisecond", 1): 25,
    ("dt.second", 1): 26,
    ("dt.minute", 1): 27,
    ("dt.hour", 1): 28,
    ("dt.day", 1): 29,
    ("dt.month", 1): 30,
    ("dt.year", 1): 31,
    ("dt.day_of_week", 1): 32,
    ("dt.day_of_year", 1): 33,
    ("dt.timestamp", 2): 34,
    ("dt.strftime", 2): 35,
    ("dt.round", 2): 36,
    ("dt.floor", 2): 37,
    ("dt.nanoseconds", 1): 38,
    ("dt.microseconds", 1): 39,
    ("dt.milliseconds", 1): 40,
    ("dt.seconds", 1): 41,
    ("dt.minutes", 1): 42,
    ("dt.hours", 1): 43,
    ("dt.days", 1): 44,
    ("dt.weeks", 1): 45,
    ("num.abs", 1): 46,
    ("num.fill_na", 2): 47,
    ("num.round", 2): 48,
    ("str.split", 2): 49,  # whitespace split: (s, maxsplit)
    ("str.split", 3): 49,  # separator split: (s, sep, maxsplit)
    ("dt.from_timestamp", 2): 50,  # (x, scale)
    ("dt.utc_from_timestamp", 2): 51,  # (x, scale)
    ("dt.to_utc", 2): 52,  # (d, tz_table)
    ("dt.to_naive_in_timezone", 2): 53,  # (d, tz_table)
}

# binary op ids — must mirror enum VmBin
BIN_IDS = {
    "+": 0, "-": 1, "*": 2, "/": 3, "//": 4, "%": 5, "**": 6, "@": 7,
    "==": 8, "!=": 9, "<": 10, "<=": 11, ">": 12, ">=": 13,
    "&": 14, "|": 15, "^": 16,
}

_CAST_IDS = {dt.INT: 0, dt.FLOAT: 1, dt.BOOL: 2, dt.STR: 3}

# ---------------------------------------------------------------------------
# program shape tables — the single source of truth for code rewriting
# (fusion splices in analysis/rewrite.py, abstract interpretation in
# analysis/vm_abstract.py).  Code is a flat int list; every opcode has a
# fixed operand count, and each operand slot is exactly one of: a plain
# immediate, an absolute jump target, an index into the const pool, or an
# index into the pyfunc pool.

#: operand word count per opcode
OPERAND_WIDTHS = {
    OP_LOAD_COL: 1,
    OP_LOAD_KEY: 0,
    OP_LOAD_CONST: 1,
    OP_CALL_PY: 1,
    OP_BIN: 1,
    OP_NEG: 0,
    OP_INV: 0,
    OP_IS_NONE: 0,
    OP_BRANCH: 2,
    OP_JUMP: 1,
    OP_JUMP_NOT_NONE: 1,
    OP_POP: 0,
    OP_REQUIRE: 1,
    OP_UNWRAP: 0,
    OP_FILL_JUMP: 1,
    OP_CAST: 1,
    OP_CONVERT: 2,
    OP_MAKE_TUPLE: 1,
    OP_GET: 2,
    OP_POINTER: 3,
    OP_METHOD: 3,
}

#: operand slots holding absolute jump targets (may equal len(code) = END)
_JUMP_SLOTS = {
    OP_BRANCH: (0, 1),
    OP_JUMP: (0,),
    OP_JUMP_NOT_NONE: (0,),
    OP_REQUIRE: (0,),
    OP_FILL_JUMP: (0,),
    OP_GET: (1,),
}

#: operand slots indexing the const pool
_CONST_SLOTS = {OP_LOAD_CONST: (0,), OP_POINTER: (2,)}

#: operand slots indexing the pyfunc pool
_PYFUNC_SLOTS = {OP_CALL_PY: (0,)}


def iter_program(code: list[int]):
    """Yield ``(pc, op, operands)`` walking a flat code list.  Raises
    ``ValueError`` on an unknown opcode — rewriting a program it cannot
    fully parse would corrupt it."""
    pc = 0
    n = len(code)
    while pc < n:
        op = code[pc]
        width = OPERAND_WIDTHS.get(op)
        if width is None:
            raise ValueError(f"unknown opcode {op} at pc {pc}")
        yield pc, op, code[pc + 1 : pc + 1 + width]
        pc += 1 + width


def renumber_columns(code: list[int], mapping: Any) -> list[int]:
    """Return a copy of ``code`` with every ``OP_LOAD_COL`` operand
    remapped through ``mapping`` (a dict or callable).  The register
    renumbering primitive behind filter pushdown: a predicate compiled
    against a join's output frame (left cols ``0..ln-1``, right cols
    ``ln..ln+rn-1``) is retargeted at one side's input frame by shifting
    its column registers.  Raises ``KeyError`` when a register has no
    mapping — the caller must have proven the program only touches the
    columns being remapped."""
    out = list(code)
    get = mapping.__getitem__ if hasattr(mapping, "__getitem__") else mapping
    for pc, op, ops in iter_program(code):
        if op == OP_LOAD_COL:
            out[pc + 1] = get(ops[0])
    return out


def concat_programs(
    down: tuple[list[int], list[Any], list[Any]],
    columns: dict[int, tuple[list[int], list[Any], list[Any]]],
) -> tuple[list[int], list[Any], list[Any]]:
    """Fuse two adjacent row programs into one: inline an upstream
    select's per-column programs into a downstream program at each
    ``OP_LOAD_COL`` site.

    ``down`` and each ``columns[pos]`` are raw ``(code, consts,
    pyfuncs)`` triples (see :func:`lower_raw`).  The result evaluates
    the downstream program against the *upstream's input* frame: where
    the downstream loaded column ``pos`` of the intermediate frame, it
    now computes that column's defining program in place.  Upstream
    jump targets shift by their splice offset; downstream jump targets
    are remapped through a pc map built in the same walk (inlined code
    changes all downstream offsets); const/pyfunc indices renumber into
    the merged pools.  ``OP_LOAD_KEY`` needs no fixup — selects preserve
    row keys, so both frames share the key.

    Raises ``KeyError`` if the downstream loads a column with no
    supplied program, ``ValueError`` on unparseable code."""
    dcode, dconsts, dpy = down
    out: list[int] = []
    consts: list[Any] = []
    pyfuncs: list[Any] = []
    offsets: dict[Any, tuple[int, int]] = {}

    def _pool(key: Any, c: list[Any], p: list[Any]) -> tuple[int, int]:
        if key not in offsets:
            offsets[key] = (len(consts), len(pyfuncs))
            consts.extend(c)
            pyfuncs.extend(p)
        return offsets[key]

    pc_map: dict[int, int] = {}
    jump_fixes: list[tuple[int, int]] = []  # (out slot, old down target)
    for pc, op, ops in iter_program(dcode):
        pc_map[pc] = len(out)
        if op == OP_LOAD_COL:
            ucode, uconsts, upy = columns[ops[0]]
            coff, poff = _pool(("col", ops[0]), uconsts, upy)
            base = len(out)
            piece = list(ucode)
            for upc, uop, uops in iter_program(ucode):
                for s in _JUMP_SLOTS.get(uop, ()):
                    piece[upc + 1 + s] = base + uops[s]
                for s in _CONST_SLOTS.get(uop, ()):
                    piece[upc + 1 + s] = coff + uops[s]
                for s in _PYFUNC_SLOTS.get(uop, ()):
                    piece[upc + 1 + s] = poff + uops[s]
            out.extend(piece)
            continue
        coff, poff = _pool("down", dconsts, dpy)
        start = len(out)
        out.append(op)
        out.extend(ops)
        for s in _JUMP_SLOTS.get(op, ()):
            jump_fixes.append((start + 1 + s, ops[s]))
        for s in _CONST_SLOTS.get(op, ()):
            out[start + 1 + s] = coff + ops[s]
        for s in _PYFUNC_SLOTS.get(op, ()):
            out[start + 1 + s] = poff + ops[s]
    pc_map[len(dcode)] = len(out)
    for slot, old_t in jump_fixes:
        out[slot] = pc_map[old_t]
    return out, consts, pyfuncs


def lower_raw(e: "ex.ColumnExpression", layout: Any) -> "_Asm | None":
    """Lower one expression to an open-coded :class:`_Asm` (raw
    ``code``/``consts``/``pyfuncs`` lists) for the rewriter to splice,
    without compiling a capsule.  None when lowering fails."""
    asm = _Asm(layout)
    try:
        _lower(e, asm)
    except Exception:  # lowering must never break the rewriter
        return None
    return asm


def compile_triple(
    triple: tuple[list[int], list[Any], list[Any]]
) -> Any | None:
    """Compile a raw ``(code, consts, pyfuncs)`` triple to a VM program
    capsule, or None when the native module is absent or rejects it."""
    native = _native.load()
    if native is None:
        return None
    code, consts, pyfuncs = triple
    try:
        return native.vm_compile(list(code), tuple(consts), tuple(pyfuncs))
    except Exception:
        return None


class _Asm:
    def __init__(self, layout: Any):
        self.layout = layout
        self.code: list[int] = []
        self.consts: list[Any] = []
        self.pyfuncs: list[Any] = []
        self.native_ops = 0  # CALL_PY-only programs aren't worth running

    def emit(self, *xs: int) -> None:
        self.code.extend(xs)

    def const(self, v: Any) -> int:
        self.consts.append(v)
        return len(self.consts) - 1

    def here(self) -> int:
        return len(self.code)

    def patch(self, pos: int, val: int) -> None:
        self.code[pos] = val

    def fallback(self, e: ex.ColumnExpression) -> None:
        """Embed the subtree's ordinary Python closure as one CALL_PY."""
        fn = e._compile(self.layout.resolver)
        self.pyfuncs.append(fn)
        self.emit(OP_CALL_PY, len(self.pyfuncs) - 1)


def _lower(e: ex.ColumnExpression, asm: _Asm) -> None:
    t = type(e)
    if t is ex.ConstExpression:
        asm.emit(OP_LOAD_CONST, asm.const(e._value))
        asm.native_ops += 1
        return
    if t is ex.ColumnReference:
        pos = asm.layout.resolve_pos(e)
        if pos is None:
            asm.fallback(e)
            return
        if pos == -1:
            asm.emit(OP_LOAD_KEY)
        else:
            asm.emit(OP_LOAD_COL, pos)
        asm.native_ops += 1
        return
    if t is ex.BinaryExpression:
        bid = BIN_IDS.get(e._op)
        if bid is None:
            asm.fallback(e)
            return
        _lower(e._left, asm)
        _lower(e._right, asm)
        asm.emit(OP_BIN, bid)
        asm.native_ops += 1
        return
    if t is ex.UnaryExpression:
        _lower(e._operand, asm)
        asm.emit(OP_NEG if e._op == "-" else OP_INV)
        asm.native_ops += 1
        return
    if t is ex.IsNoneExpression:
        _lower(e._expr, asm)
        asm.emit(OP_IS_NONE)
        asm.native_ops += 1
        return
    if t is ex.IfElseExpression:
        _lower(e._cond, asm)
        asm.emit(OP_BRANCH, 0, 0)
        fix = asm.here() - 2  # (else_t, end_t)
        _lower(e._then, asm)
        asm.emit(OP_JUMP, 0)
        jfix = asm.here() - 1
        asm.patch(fix, asm.here())  # else target
        _lower(e._else, asm)
        end = asm.here()
        asm.patch(fix + 1, end)
        asm.patch(jfix, end)
        asm.native_ops += 1
        return
    if t is ex.CoalesceExpression:
        if not e._args:
            asm.emit(OP_LOAD_CONST, asm.const(None))
            asm.native_ops += 1
            return
        jumps = []
        for i, a in enumerate(e._args):
            _lower(a, asm)
            if i < len(e._args) - 1:
                asm.emit(OP_JUMP_NOT_NONE, 0)
                jumps.append(asm.here() - 1)
                asm.emit(OP_POP)
        end = asm.here()
        for j in jumps:
            asm.patch(j, end)
        asm.native_ops += 1
        return
    if t is ex.RequireExpression:
        fixes = []
        for d in e._deps:
            _lower(d, asm)
            asm.emit(OP_REQUIRE, 0)
            fixes.append(asm.here() - 1)
        _lower(e._value, asm)
        end = asm.here()
        for f in fixes:
            asm.patch(f, end)
        asm.native_ops += 1
        return
    if t is ex.CastExpression:
        tid = _CAST_IDS.get(e._target.strip_optional())
        _lower(e._expr, asm)
        if tid is None:
            return  # unknown target passes the value through (closure parity)
        asm.emit(OP_CAST, tid)
        asm.native_ops += 1
        return
    if t is ex.ConvertExpression:
        native = _native.load()
        tid = _CAST_IDS.get(e._target.strip_optional())
        if tid is None or native is None or not _json_registered(native):
            asm.fallback(e)
            return
        _lower(e._expr, asm)
        asm.emit(OP_CONVERT, tid, 1 if e._unwrap else 0)
        asm.native_ops += 1
        return
    if t is ex.MakeTupleExpression:
        for a in e._args:
            _lower(a, asm)
        asm.emit(OP_MAKE_TUPLE, len(e._args))
        asm.native_ops += 1
        return
    if t is ex.GetExpression:
        native = _native.load()
        if native is None or not _json_registered(native):
            asm.fallback(e)
            return
        _lower(e._obj, asm)
        _lower(e._index, asm)
        strict = 0 if e._check else 1
        asm.emit(OP_GET, strict, 0)
        fix = asm.here() - 1
        if e._check:
            _lower(e._default, asm)
        asm.patch(fix, asm.here())
        asm.native_ops += 1
        return
    if t is ex.UnwrapExpression:
        _lower(e._expr, asm)
        asm.emit(OP_UNWRAP)
        asm.native_ops += 1
        return
    if t is ex.FillErrorExpression:
        _lower(e._expr, asm)
        asm.emit(OP_FILL_JUMP, 0)
        fix = asm.here() - 1
        asm.emit(OP_POP)
        _lower(e._replacement, asm)
        asm.patch(fix, asm.here())
        asm.native_ops += 1
        return
    if t is ex.DeclareTypeExpression:
        _lower(e._expr, asm)
        return
    if t is ex.PointerExpression:
        # closure parity: only _args are evaluated (instance is a
        # grouping hint, not hash material — expression.py:688-698)
        for a in e._args:
            _lower(a, asm)
        rs_idx = asm.const(keys.ref_scalar)
        asm.emit(
            OP_POINTER, len(e._args), 1 if e._optional else 0, rs_idx
        )
        asm.native_ops += 1
        return
    if t is ex.MethodCallExpression:
        mid = _METHOD_IDS.get((e._method_name, len(e._args)))
        if mid is None:
            asm.fallback(e)
            return
        for a in e._args:
            _lower(a, asm)
        asm.emit(
            OP_METHOD, mid, len(e._args), 1 if e._propagate_none else 0
        )
        asm.native_ops += 1
        return
    # ApplyExpression (+async variants) and any future node types run as
    # their ordinary Python closure
    asm.fallback(e)


def _json_registered(native: Any) -> bool:
    return getattr(native, "_json_registered", False)


def lower_program(e: ex.ColumnExpression, layout: Any) -> Any | None:
    """Compile one expression to a VM program capsule, or None when the
    native module is absent or nothing in the tree lowers natively."""
    native = _native.load()
    if native is None:
        return None
    asm = _Asm(layout)
    try:
        _lower(e, asm)
    except Exception:  # lowering must never break graph build
        return None
    if asm.native_ops == 0:
        return None  # pure CALL_PY: the closure path is already optimal
    try:
        return native.vm_compile(asm.code, tuple(asm.consts), tuple(asm.pyfuncs))
    except Exception:
        return None


def lower_programs(exprs: list[ex.ColumnExpression], layout: Any) -> Any | None:
    """Capsules for a select's output columns.  A column with no native
    lowering still becomes a one-CALL_PY program (the batch loop is the
    same either way), but if NO column lowers natively the select keeps
    the existing rowwise_map closure path — identical performance, less
    machinery."""
    native = _native.load()
    if native is None:
        return None
    asms = []
    total_native = 0
    for e in exprs:
        asm = _Asm(layout)
        try:
            _lower(e, asm)
        except Exception:  # lowering must never break graph build
            return None
        total_native += asm.native_ops
        asms.append(asm)
    if total_native == 0:
        return None
    try:
        return tuple(
            native.vm_compile(a.code, tuple(a.consts), tuple(a.pyfuncs))
            for a in asms
        )
    except Exception:
        return None


def project_program(positions: list[int]) -> Any | None:
    """A program per position for pure column projection (filter's
    project-back node): LOAD_COL only."""
    native = _native.load()
    if native is None:
        return None
    try:
        return tuple(
            native.vm_compile([OP_LOAD_COL, p], (), ()) for p in positions
        )
    except Exception:
        return None
