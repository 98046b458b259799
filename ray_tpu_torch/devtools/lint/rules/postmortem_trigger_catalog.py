"""postmortem-trigger-catalog: the anomaly trigger catalog is closed.

Mirrors the metric/chaos/flight catalog rules for the trigger bus
(observability/postmortem.py TRIGGERS):

- every literal kind at a publish site — `publish_trigger("<kind>")` or
  the GCS's in-process `_trigger("<kind>")` — must be declared in the
  TRIGGERS catalog (an undeclared kind opens incidents no report or
  dashboard legend can explain), and
- every declared kind must have at least one compiled-in publish site (a
  kind with no site is a dead entry readers trust but nothing fires).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Sequence, Set, Tuple

from ..framework import Analyzer, FileContext, Finding, register

RULE = "postmortem-trigger-catalog"

POSTMORTEM_PATH = "ray_tpu_torch/observability/postmortem.py"

_PUBLISH_FN_NAMES = {"publish_trigger", "_trigger"}


def declared_triggers(ctx: FileContext) -> Tuple[Set[str], int]:
    """(declared kinds, catalog lineno) from the module-level
    `TRIGGERS = {...}` dict in postmortem.py."""
    for node in ctx.tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == "TRIGGERS"
            and isinstance(node.value, ast.Dict)
        ):
            kinds = {
                k.value for k in node.value.keys
                if isinstance(k, ast.Constant) and isinstance(k.value, str)
            }
            return kinds, node.lineno
    return set(), 1


def _call_literal(node: ast.Call, fn_names: Set[str]) -> str:
    fn = node.func
    name = fn.id if isinstance(fn, ast.Name) else (fn.attr if isinstance(fn, ast.Attribute) else None)
    if (
        name in fn_names
        and node.args
        and isinstance(node.args[0], ast.Constant)
        and isinstance(node.args[0].value, str)
    ):
        return node.args[0].value
    return ""


@register
class PostmortemTriggerCatalog(Analyzer):
    name = RULE
    per_file = False
    description = (
        "anomaly trigger kinds published to the bus must round-trip with "
        "the postmortem TRIGGERS catalog"
    )

    def check_tree(self, ctxs: Sequence[FileContext]) -> Iterable[Finding]:
        by_path = {c.path: c for c in ctxs}
        findings: List[Finding] = []

        pm_ctx = by_path.get(POSTMORTEM_PATH)
        # Partial-tree invocation (linting one file without the catalog
        # module): nothing to check against.
        declared, catalog_lineno = (
            declared_triggers(pm_ctx) if pm_ctx else (set(), 1)
        )
        if not declared:
            return findings

        sites: Dict[str, int] = {}
        for ctx in ctxs:
            for node in ast.walk(ctx.tree):
                if not isinstance(node, ast.Call):
                    continue
                kind = _call_literal(node, _PUBLISH_FN_NAMES)
                if not kind:
                    continue
                if kind not in declared:
                    if not ctx.suppressed(RULE, node.lineno):
                        findings.append(ctx.finding(
                            RULE, node.lineno,
                            f"trigger kind {kind!r} is not declared in "
                            f"{POSTMORTEM_PATH} TRIGGERS",
                        ))
                else:
                    sites[kind] = sites.get(kind, 0) + 1

        for kind in sorted(declared):
            if sites.get(kind, 0) == 0 and not pm_ctx.suppressed(RULE, catalog_lineno):
                findings.append(pm_ctx.finding(
                    RULE, catalog_lineno,
                    f"trigger kind {kind!r} is declared in TRIGGERS but has "
                    "no compiled-in publish site",
                ))
        return findings
