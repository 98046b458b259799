"""lock-discipline: locks are `with`-scoped and never double-acquired.

Two static invariants:

- **bare acquire**: `lock.acquire()` outside a `with` means a raise
  between acquire and release leaks the lock forever (the thread that
  hits the leaked lock next wedges silently — the exact failure the
  dynamic lock-order detector exists to catch at runtime). Use `with`.
- **double acquire**: a `with self._lock:` nested inside another
  `with self._lock:` in the same function is an instant self-deadlock
  for a non-reentrant threading.Lock. (RLock-named locks — terminal
  identifier containing "rlock" — are exempt; cross-file RLock-ness is
  the dynamic detector's job.)
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from ..framework import Analyzer, FileContext, Finding, register
from .blocking_in_loop import _is_lockish, _terminal_name

RULE = "lock-discipline"


def _is_rlockish(expr: ast.expr) -> bool:
    name = _terminal_name(expr)
    return bool(name) and "rlock" in name.lower()


class _Visitor(ast.NodeVisitor):
    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self.with_stack: List[str] = []
        self.findings: List[Finding] = []

    def _visit_func(self, node) -> None:
        # Each function body is its own scope for double-acquire: a helper
        # called under the lock is the dynamic detector's problem.
        saved, self.with_stack = self.with_stack, []
        self.generic_visit(node)
        self.with_stack = saved

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_With(self, node: ast.With) -> None:
        held: List[str] = []
        for item in node.items:
            expr = item.context_expr
            if not _is_lockish(expr) or _is_rlockish(expr):
                continue
            text = ast.unparse(expr)
            if text in self.with_stack:
                self.findings.append(self.ctx.finding(
                    RULE, node.lineno,
                    f"double acquire of {text!r} in one function: instant "
                    "self-deadlock for a non-reentrant threading.Lock",
                ))
            held.append(text)
        self.with_stack.extend(held)
        self.generic_visit(node)
        del self.with_stack[len(self.with_stack) - len(held):]

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if (
            isinstance(fn, ast.Attribute)
            and fn.attr == "acquire"
            and _is_lockish(fn.value)
        ):
            self.findings.append(self.ctx.finding(
                RULE, node.lineno,
                f"bare {ast.unparse(fn.value)}.acquire(): a raise before "
                "release leaks the lock; use `with`",
            ))
        self.generic_visit(node)


@register
class LockDiscipline(Analyzer):
    name = RULE
    description = (
        "flag lock.acquire() outside `with`, and nested with-acquire of "
        "the same non-reentrant lock in one function"
    )

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        v = _Visitor(ctx)
        v.visit(ctx.tree)
        return v.findings
