"""typed-raise: raises crossing RPC/process boundaries use the taxonomy.

The RPC surface is "public methods on the service object" (core/rpc.py
RpcServer); whatever a handler raises is pickled and re-raised verbatim
on the caller. A bare `RuntimeError("placement group removed")` crossing
that boundary strips the caller of everything `ray_tpu_torch/exceptions.py`
exists to provide: isinstance-based retry policy, structured context
(who/what/how long), and stable identity across versions. Handlers must
raise taxonomy types (anything defined in exceptions.py, or a subclass
defined locally).

Scope: public (non-underscore) methods of the classes served over
RpcServer, enumerated in RPC_SERVICE_CLASSES. Only `raise <Builtin>(...)`
is flagged — re-raises and raises of locally constructed/taxonomy types
pass.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Sequence, Set

from ..framework import Analyzer, FileContext, Finding, register

RULE = "typed-raise"

# Classes whose public methods ARE the RPC surface (served via RpcServer
# or invoked cross-process as actor control planes).
RPC_SERVICE_CLASSES = {
    "GcsService",
    "RayletService",
    "ServeController",
}

_BUILTIN_EXCEPTIONS = {
    "Exception", "RuntimeError", "ValueError", "KeyError", "TypeError",
    "OSError", "IOError", "NotImplementedError", "AssertionError",
    "LookupError", "IndexError", "AttributeError", "StopIteration",
    "ArithmeticError", "ZeroDivisionError",
}
# Builtins that already carry cross-process meaning (timeouts and
# connection failures map onto caller retry logic the same way the
# taxonomy's subclasses of them do).
_ALLOWED_BUILTINS = {"TimeoutError", "ConnectionError", "InterruptedError"}


def _taxonomy_names(ctxs: Sequence[FileContext]) -> Set[str]:
    for ctx in ctxs:
        if ctx.path == "ray_tpu_torch/exceptions.py":
            return {
                node.name
                for node in ast.walk(ctx.tree)
                if isinstance(node, ast.ClassDef)
            }
    return set()


@register
class TypedRaise(Analyzer):
    name = RULE
    per_file = False
    description = (
        "public RPC-service methods must raise ray_tpu_torch/exceptions.py "
        "taxonomy types, not bare builtins"
    )

    def check_tree(self, ctxs: Sequence[FileContext]) -> Iterable[Finding]:
        taxonomy = _taxonomy_names(ctxs)
        findings: List[Finding] = []
        for ctx in ctxs:
            for cls in ast.walk(ctx.tree):
                if not isinstance(cls, ast.ClassDef) or cls.name not in RPC_SERVICE_CLASSES:
                    continue
                for meth in cls.body:
                    if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        continue
                    if meth.name.startswith("_"):
                        continue
                    for node in ast.walk(meth):
                        if not isinstance(node, ast.Raise) or node.exc is None:
                            continue
                        exc = node.exc
                        name = None
                        if isinstance(exc, ast.Call) and isinstance(exc.func, ast.Name):
                            name = exc.func.id
                        elif isinstance(exc, ast.Name):
                            name = exc.id if exc.id in _BUILTIN_EXCEPTIONS else None
                        if (
                            name in _BUILTIN_EXCEPTIONS
                            and name not in taxonomy
                            and name not in _ALLOWED_BUILTINS
                        ):
                            if ctx.suppressed(RULE, node.lineno):
                                continue
                            findings.append(ctx.finding(
                                RULE, node.lineno,
                                f"raise {name} in RPC handler "
                                f"{cls.name}.{meth.name}() crosses the "
                                "process boundary untyped; use the "
                                "ray_tpu_torch/exceptions.py taxonomy",
                            ))
        return findings
