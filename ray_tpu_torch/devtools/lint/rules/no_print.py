"""no-print: runtime code logs through the structured logger.

Bare `print(...)` in `ray_tpu_torch/` vanishes when the process dies, carries no
node/worker/task attribution, and bypasses the capture/dedup path.
Escape hatches:

- `ray_tpu_torch/scripts.py` is the CLI; its prints ARE the user output.
- a call marked `# console-output: <why>` (same line or line above) is
  deliberate console IO — bootstrap protocol announcements the parent
  parses, the driver's attributed re-print of captured worker output.
"""

from __future__ import annotations

import ast
from typing import Iterable

from ..framework import Analyzer, FileContext, Finding, register

RULE = "no-print"
MARKER = "console-output"
ALLOWED_FILES = {"ray_tpu_torch/scripts.py"}


def _marker_near(ctx: FileContext, line: int) -> bool:
    for ln in (line, line - 1):
        if MARKER in ctx.source_line(ln):
            return True
    return False


@register
class NoPrint(Analyzer):
    name = RULE
    description = (
        "bare print() in runtime code; use observability.logs.get_logger "
        f"or mark deliberate console IO with `# {MARKER}: <why>`"
    )

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.path in ALLOWED_FILES or not ctx.path.startswith("ray_tpu_torch/"):
            return
        for node in ast.walk(ctx.tree):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "print"
                and not _marker_near(ctx, node.lineno)
            ):
                yield ctx.finding(
                    RULE, node.lineno,
                    "bare print() in runtime code; use the structured "
                    f"logger or mark `# {MARKER}: <why>`",
                )
