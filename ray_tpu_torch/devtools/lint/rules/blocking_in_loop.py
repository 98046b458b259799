"""blocking-in-loop: no blocking calls while holding a lock or inside a
control-plane tick function.

Two bug classes:

- a `time.sleep`/`subprocess.run`/socket recv under a held lock stalls
  every thread contending on that lock for the full blocking duration —
  in the raylet that is the scheduler, the monitor, and every RPC
  handler at once;
- a `time.sleep` inside a tick loop ignores the stop event, so shutdown
  and drain wait out the sleep (use `self._stop.wait(interval)`).

Lock detection is heuristic by name (with-items whose terminal
identifier looks like a lock/condition). Condition `.wait()` calls are
exempt — they release the lock while blocking; that is the correct
pattern.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional

from ..framework import Analyzer, FileContext, Finding, register

RULE = "blocking-in-loop"

# Files whose `*_loop`/`*_tick` functions are control-plane ticks: a
# blocking call there wedges cluster liveness, not just one caller.
TICK_FILES = (
    "ray_tpu_torch/core/raylet.py",
    "ray_tpu_torch/core/gcs.py",
    "ray_tpu_torch/serve/controller.py",
)

_BLOCKING_MODULE_CALLS = {
    ("time", "sleep"),
    ("subprocess", "run"),
    ("subprocess", "call"),
    ("subprocess", "check_call"),
    ("subprocess", "check_output"),
    ("socket", "create_connection"),
}
_BLOCKING_METHOD_NAMES = {"recv", "recv_into", "accept"}

_LOCK_TOKENS = ("lock", "mutex", "_mu")
_CV_TOKENS = ("_cv", "cond")


def _terminal_name(expr: ast.expr) -> Optional[str]:
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return None


def _is_lockish(expr: ast.expr) -> bool:
    name = _terminal_name(expr)
    if not name:
        return False
    low = name.lower()
    return any(t in low for t in _LOCK_TOKENS) or any(
        low.endswith(t) or low == t.lstrip("_") for t in _CV_TOKENS
    )


def _blocking_reason(call: ast.Call) -> Optional[str]:
    fn = call.func
    if isinstance(fn, ast.Attribute):
        if isinstance(fn.value, ast.Name) and (fn.value.id, fn.attr) in _BLOCKING_MODULE_CALLS:
            return f"{fn.value.id}.{fn.attr}()"
        if fn.attr in _BLOCKING_METHOD_NAMES:
            return f".{fn.attr}()"
    return None


class _Visitor(ast.NodeVisitor):
    def __init__(self, ctx: FileContext, is_tick_file: bool):
        self.ctx = ctx
        self.is_tick_file = is_tick_file
        self.lock_stack: List[str] = []   # source text of held with-locks
        self.func_stack: List[str] = []
        self.findings: List[Finding] = []

    # -- function tracking ------------------------------------------------
    def _visit_func(self, node) -> None:
        self.func_stack.append(node.name)
        self.generic_visit(node)
        self.func_stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def _in_tick(self) -> Optional[str]:
        if not self.is_tick_file:
            return None
        for name in self.func_stack:
            if name.endswith("_loop") or name.endswith("_tick"):
                return name
        return None

    # -- with-lock tracking ----------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        held = [
            ast.unparse(item.context_expr)
            for item in node.items
            if _is_lockish(item.context_expr)
        ]
        self.lock_stack.extend(held)
        self.generic_visit(node)
        del self.lock_stack[len(self.lock_stack) - len(held):]

    # -- calls ------------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        reason = _blocking_reason(node)
        if reason is not None:
            # Condition.wait-style calls release the lock; never flag them.
            if self.lock_stack:
                self.findings.append(self.ctx.finding(
                    RULE, node.lineno,
                    f"blocking call {reason} while holding "
                    f"{self.lock_stack[-1]!r} stalls every contender; move "
                    "the blocking work outside the critical section",
                ))
            else:
                tick = self._in_tick()
                if tick and reason == "time.sleep()":
                    self.findings.append(self.ctx.finding(
                        RULE, node.lineno,
                        f"time.sleep in tick function {tick}() ignores the "
                        "stop event; use the stop Event's wait(interval)",
                    ))
                elif tick and reason.startswith("subprocess."):
                    self.findings.append(self.ctx.finding(
                        RULE, node.lineno,
                        f"subprocess call in tick function {tick}() blocks "
                        "the control loop; run it off-thread or bound it",
                    ))
        self.generic_visit(node)


@register
class BlockingInLoop(Analyzer):
    name = RULE
    description = (
        "no time.sleep/subprocess/socket-recv while holding a lock, and no "
        "time.sleep/subprocess inside raylet/GCS/serve-controller tick loops"
    )

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        v = _Visitor(ctx, is_tick_file=ctx.path in TICK_FILES)
        v.visit(ctx.tree)
        return v.findings
