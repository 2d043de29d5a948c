"""Abstract interpretation over expression-VM bytecode.

The analyzer reasons about the SAME flat postfix programs the native VM
executes (``internals/expr_vm.py``) instead of the expression AST, so
what gets linted is what actually runs: jump-lowered lazy constructs,
``CALL_PY`` fallback islands, cast/convert ops.  Because the native
module may be absent (or a subtree may not lower), lowering here uses
:class:`_LintAsm`, which records the *expression* for every fallback
instead of compiling its Python closure — the bytecode shape is
identical to what ``lower_program`` would produce, with no native
dependency and no closure-compilation cost.

The interpreter itself is a standard worklist fixpoint: abstract state =
the dtype stack at each pc, merged pointwise with ``dt.lub``.  Jump ops
refine the stack on their taken edge (``OP_JUMP_NOT_NONE`` strips
Optional; ``OP_REQUIRE`` injects NONE at the join), which is how
nullability facts flow — the same role ``Optional`` narrowing plays in
the reference type interpreter.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expr_vm as vm
from pathway_tpu_torch.internals import expression as ex
from pathway_tpu_torch.internals.type_interpreter import (
    TypeInterpreterError,
    binary_result_dtype,
    unary_result_dtype,
)

#: operand word count per opcode (code is a flat int list) — shared with
#: the program-rewriting helpers (concat/renumber) in expr_vm
_N_OPERANDS = vm.OPERAND_WIDTHS

_CAST_DTYPES = {0: dt.INT, 1: dt.FLOAT, 2: dt.BOOL, 3: dt.STR}


class _LintAsm(vm._Asm):
    """``_Asm`` that never touches the native module: fallbacks record
    the expression subtree itself (its ``_dtype`` is the abstract value
    ``OP_CALL_PY`` pushes), so lowering works for analysis even when
    ``native.load()`` would return None."""

    def fallback(self, e: ex.ColumnExpression) -> None:
        self.pyfuncs.append(e)
        self.emit(vm.OP_CALL_PY, len(self.pyfuncs) - 1)


def lint_lower(e: ex.ColumnExpression, layout: Any) -> "_LintAsm | None":
    """Lower one expression for analysis; None when lowering fails
    (analysis must never break on exotic expressions)."""
    asm = _LintAsm(layout)
    try:
        vm._lower(e, asm)
    except Exception:
        return None
    return asm


def iter_ops(code: list[int]):
    """Yield ``(pc, op, operands)`` walking the flat code list."""
    pc = 0
    n = len(code)
    while pc < n:
        op = code[pc]
        width = _N_OPERANDS.get(op)
        if width is None:
            return  # unknown opcode: stop rather than misparse
        yield pc, op, code[pc + 1 : pc + 1 + width]
        pc += 1 + width


def count_call_py(code: list[int]) -> int:
    return sum(1 for _, op, _ in iter_ops(code) if op == vm.OP_CALL_PY)


class AbstractResult:
    """Outcome of abstractly executing one program."""

    def __init__(self) -> None:
        self.result_dtype: dt.DType = dt.ANY
        self.call_py_count: int = 0
        #: ``(op, left, right)`` triples the type interpreter rejected
        self.type_conflicts: list[tuple[str, dt.DType, dt.DType]] = []
        self.ok: bool = False


def _const_dtype(v: Any) -> dt.DType:
    try:
        return dt.dtype_of_value(v)
    except Exception:
        return dt.ANY


def _expr_dtype(e: Any) -> dt.DType:
    d = getattr(e, "_dtype", None)
    return d if isinstance(d, dt.DType) else dt.ANY


def _merge(a: tuple, b: tuple) -> "tuple | None":
    if len(a) != len(b):
        return None
    return tuple(dt.lub(x, y) for x, y in zip(a, b))


def interpret(
    code: list[int],
    consts: list[Any],
    pyexprs: list[Any],
    col_dtypes: "dict[int, dt.DType] | None" = None,
) -> AbstractResult:
    """Run the worklist fixpoint; ``col_dtypes`` maps ``OP_LOAD_COL``
    positions to input dtypes (missing → ANY).  Bails out (``ok=False``)
    on stack-shape anomalies instead of guessing."""
    res = AbstractResult()
    res.call_py_count = count_call_py(code)
    cols = col_dtypes or {}
    widths = _N_OPERANDS

    # pc -> abstract stack (tuple of dtypes); END is pc == len(code)
    states: dict[int, tuple] = {0: ()}
    work = [0]
    end_state: "tuple | None" = None
    steps = 0

    def push_state(pc: int, stack: tuple) -> bool:
        nonlocal end_state
        if pc >= len(code):
            merged = stack if end_state is None else _merge(end_state, stack)
            if merged is None:
                return False
            end_state = merged
            return True
        old = states.get(pc)
        if old is None:
            states[pc] = stack
            work.append(pc)
            return True
        merged = _merge(old, stack)
        if merged is None:
            return False
        if merged != old:
            states[pc] = merged
            work.append(pc)
        return True

    while work:
        steps += 1
        if steps > 10_000:  # lattice has finite height; belt and braces
            return res
        pc = work.pop()
        stack = list(states.get(pc, ()))
        if pc >= len(code):
            continue
        op = code[pc]
        w = widths.get(op)
        if w is None:
            return res
        operands = code[pc + 1 : pc + 1 + w]
        nxt = pc + 1 + w
        try:
            if op == vm.OP_LOAD_COL:
                stack.append(cols.get(operands[0], dt.ANY))
            elif op == vm.OP_LOAD_KEY:
                stack.append(dt.POINTER)
            elif op == vm.OP_LOAD_CONST:
                stack.append(_const_dtype(consts[operands[0]]))
            elif op == vm.OP_CALL_PY:
                stack.append(_expr_dtype(pyexprs[operands[0]]))
            elif op == vm.OP_BIN:
                r, l = stack.pop(), stack.pop()
                opname = _BIN_NAMES.get(operands[0], "?")
                try:
                    stack.append(binary_result_dtype(opname, l, r))
                except TypeInterpreterError:
                    res.type_conflicts.append((opname, l, r))
                    stack.append(dt.ANY)
            elif op in (vm.OP_NEG, vm.OP_INV):
                t = stack.pop()
                opname = "-" if op == vm.OP_NEG else "~"
                try:
                    stack.append(unary_result_dtype(opname, t))
                except TypeInterpreterError:
                    res.type_conflicts.append((opname, t, t))
                    stack.append(dt.ANY)
            elif op == vm.OP_IS_NONE:
                stack.pop()
                stack.append(dt.BOOL)
            elif op == vm.OP_BRANCH:
                stack.pop()  # condition
                if not push_state(nxt, tuple(stack)):
                    return res
                if not push_state(operands[0], tuple(stack)):
                    return res
                continue
            elif op == vm.OP_JUMP:
                if not push_state(operands[0], tuple(stack)):
                    return res
                continue
            elif op == vm.OP_JUMP_NOT_NONE:
                t = stack.pop()
                # taken edge: value proven non-None
                if not push_state(
                    operands[0], tuple(stack + [t.strip_optional()])
                ):
                    return res
                # fall-through keeps the (possibly None) value for OP_POP
                if not push_state(nxt, tuple(stack + [t])):
                    return res
                continue
            elif op == vm.OP_POP:
                stack.pop()
            elif op == vm.OP_REQUIRE:
                stack.pop()  # the dep
                # dep-is-None edge: the program's RESULT becomes None
                if not push_state(operands[0], tuple(stack + [dt.NONE])):
                    return res
                if not push_state(nxt, tuple(stack)):
                    return res
                continue
            elif op == vm.OP_UNWRAP:
                t = stack.pop()
                if t == dt.NONE:
                    # unwrap(None) errors at runtime — no value flows
                    # on, so the path dies instead of leaking NONE into
                    # the end-state merge
                    continue
                stack.append(t.strip_optional())
            elif op == vm.OP_FILL_JUMP:
                t = stack.pop()
                # no-error edge jumps past the replacement, value kept
                if not push_state(operands[0], tuple(stack + [t])):
                    return res
                if not push_state(nxt, tuple(stack + [t])):
                    return res
                continue
            elif op == vm.OP_CAST:
                t = stack.pop()
                target = _CAST_DTYPES.get(operands[0], dt.ANY)
                stack.append(
                    dt.Optional(target) if t.is_optional() or t == dt.NONE
                    else target
                )
            elif op == vm.OP_CONVERT:
                t = stack.pop()
                target = _CAST_DTYPES.get(operands[0], dt.ANY)
                unwrap = bool(operands[1])
                stack.append(target if unwrap else dt.Optional(target))
            elif op == vm.OP_MAKE_TUPLE:
                n = operands[0]
                elems = stack[len(stack) - n :] if n else []
                del stack[len(stack) - n :]
                stack.append(dt.Tuple(*elems))
            elif op == vm.OP_GET:
                stack.pop()
                stack.pop()
                # hit edge jumps to end_t with the extracted value
                if not push_state(operands[1], tuple(stack + [dt.ANY])):
                    return res
                # miss edge falls through into the lowered default
                if not push_state(nxt, tuple(stack)):
                    return res
                continue
            elif op == vm.OP_POINTER:
                n = operands[0]
                if n:
                    del stack[len(stack) - n :]
                ptr = dt.POINTER
                stack.append(dt.Optional(ptr) if operands[1] else ptr)
            elif op == vm.OP_METHOD:
                n = operands[1]
                del stack[len(stack) - n :]
                stack.append(dt.ANY)
            else:
                return res
        except IndexError:
            return res  # stack underflow: malformed program, bail
        if not push_state(nxt, tuple(stack)):
            return res

    if end_state is not None and len(end_state) == 1:
        res.result_dtype = end_state[0]
        res.ok = True
    return res


_BIN_NAMES = {v: k for k, v in vm.BIN_IDS.items()}


def layout_col_dtypes(layout: Any) -> dict[int, dt.DType]:
    """pos -> input dtype, recovered from a ``_Layout``'s entries
    (``(table, {name: pos}, id_pos)`` triples)."""
    out: dict[int, dt.DType] = {}
    for entry in getattr(layout, "entries", ()):
        try:
            table, name_pos = entry[0], entry[1]
            dtypes = getattr(table, "_dtypes", {})
            for name, pos in name_pos.items():
                if pos is None or pos < 0:
                    continue
                d = dtypes.get(name)
                if isinstance(d, dt.DType):
                    out[pos] = d
        except Exception:
            continue
    return out


def analyze_expression(
    e: ex.ColumnExpression, layout: Any
) -> "AbstractResult | None":
    """Lower + interpret one expression against its layout."""
    asm = lint_lower(e, layout)
    if asm is None:
        return None
    return interpret(
        asm.code, asm.consts, asm.pyfuncs, layout_col_dtypes(layout)
    )
