"""silent-swallow: `except Exception: pass` must log or carry a reason.

The runtime's five concurrent control planes (raylet, GCS, serve
controller, trainer, cgraph exec loops) mean an exception swallowed in a
tick function is a cluster-state divergence nobody ever sees. A broad
handler whose body does NOTHING (pass/continue/...) must either log
through the structured logger or carry an explicit
`# lint: swallow-ok(<reason>)` marker saying why silence is correct
(e.g. best-effort cleanup on a dying process where the logger itself may
be gone).
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from ..framework import Analyzer, FileContext, Finding, register

RULE = "silent-swallow"

_BROAD = {"Exception", "BaseException"}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    if isinstance(t, ast.Name):
        return t.id in _BROAD
    if isinstance(t, ast.Attribute):
        return t.attr in _BROAD
    if isinstance(t, ast.Tuple):
        return any(
            (isinstance(e, ast.Name) and e.id in _BROAD)
            or (isinstance(e, ast.Attribute) and e.attr in _BROAD)
            for e in t.elts
        )
    return False


def _is_noop_body(body: List[ast.stmt]) -> bool:
    """True when the handler does literally nothing: only pass/continue/
    ellipsis/docstring statements. A handler that logs, cleans up, sets a
    flag, or re-raises is not a silent swallow."""
    for stmt in body:
        if isinstance(stmt, (ast.Pass, ast.Continue)):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant):
            continue  # docstring / ellipsis
        return False
    return True


@register
class SilentSwallow(Analyzer):
    name = RULE
    description = (
        "broad except handlers with a no-op body must log via the "
        "structured logger or carry `# lint: swallow-ok(<reason>)`"
    )

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _is_broad(node) or not _is_noop_body(node.body):
                continue
            # The marker may sit on the `except` line, the line above it,
            # or any line of the (short) no-op body.
            last = node.body[-1].lineno if node.body else node.lineno
            if any(
                ctx.swallow_ok_reason(ln) is not None
                for ln in range(node.lineno, last + 2)
            ):
                continue
            yield ctx.finding(
                RULE,
                node.lineno,
                "broad exception silently swallowed; log it "
                "(observability.logs.get_logger) or mark "
                "`# lint: swallow-ok(<reason>)`",
            )
