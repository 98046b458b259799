"""metric-catalog: the runtime's name catalogs are closed.

Three catalogs, one invariant each way:

- **metrics**: every `raytpu_*` name referenced anywhere must be
  declared in utils/internal_metrics.py metric_defs (a typo'd name in a
  test or watchdog rule silently matches nothing), and every declared
  instrument must actually be used somewhere (a dead metric is a lie in
  the catalog readers trust).
- **chaos points**: every `maybe_inject("<point>")` site must name a
  point in chaos/controller.py POINT_ACTIONS, and every declared point
  must have at least one compiled-in site (a point with no site makes a
  chaos campaign validate nothing while its telemetry says it did).
- **flight-recorder kinds**: every literal `record("<kind>")` kind must
  use a declared prefix from observability/flight_recorder.py
  KIND_PREFIXES (dump consumers group by prefix; an undeclared prefix is
  invisible to them).

Histogram exposition suffixes (`_bucket`/`_sum`/`_count`) and dynamic
name construction (literals that are a strict prefix of a declared name)
are accepted.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Sequence, Set, Tuple

from ..framework import Analyzer, FileContext, Finding, register

RULE = "metric-catalog"

METRICS_PATH = "ray_tpu_torch/utils/internal_metrics.py"
CHAOS_PATH = "ray_tpu_torch/chaos/controller.py"
FLIGHT_PATH = "ray_tpu_torch/observability/flight_recorder.py"

_METRIC_RE = re.compile(r"^raytpu_[a-z0-9_]+$")
_EXPO_SUFFIXES = ("_bucket", "_sum", "_count")
_INSTRUMENT_CTORS = {"Counter", "Gauge", "Histogram"}
_KIND_RE = re.compile(r"^[a-z0-9_]+\.[a-z0-9_.]+$")
_RECORD_FN_NAMES = {"record", "_flight_record"}


def _docstring_nodes(tree: ast.AST) -> Set[int]:
    """ids of Constant nodes that are module/class/function docstrings."""
    out: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            if (
                node.body
                and isinstance(node.body[0], ast.Expr)
                and isinstance(node.body[0].value, ast.Constant)
            ):
                out.add(id(node.body[0].value))
    return out


def declared_metrics(ctx: FileContext) -> Dict[str, Tuple[str, int]]:
    """metric name -> (instrument var name, lineno), from module-level
    `VAR = Counter("raytpu_...", ...)` assignments."""
    out: Dict[str, Tuple[str, int]] = {}
    for node in ctx.tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        target, value = node.targets[0], node.value
        if (
            isinstance(target, ast.Name)
            and isinstance(value, ast.Call)
            and isinstance(value.func, ast.Name)
            and value.func.id in _INSTRUMENT_CTORS
            and value.args
            and isinstance(value.args[0], ast.Constant)
            and isinstance(value.args[0].value, str)
        ):
            out[value.args[0].value] = (target.id, node.lineno)
    return out


def declared_chaos_points(ctx: FileContext) -> Set[str]:
    for node in ctx.tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == "POINT_ACTIONS"
            and isinstance(node.value, ast.Dict)
        ):
            return {
                k.value for k in node.value.keys
                if isinstance(k, ast.Constant) and isinstance(k.value, str)
            }
    return set()


def declared_kind_prefixes(ctx: FileContext) -> Set[str]:
    for node in ctx.tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == "KIND_PREFIXES"
            and isinstance(node.value, (ast.Set, ast.Tuple, ast.List))
        ):
            return {
                e.value for e in node.value.elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str)
            }
    return set()


def _metric_literals(ctx: FileContext, skip_decl_lines: Set[int]) -> List[Tuple[str, int]]:
    docstrings = _docstring_nodes(ctx.tree)
    out: List[Tuple[str, int]] = []
    for node in ast.walk(ctx.tree):
        if (
            isinstance(node, ast.Constant)
            and isinstance(node.value, str)
            and id(node) not in docstrings
            and node.value.startswith("raytpu_")
            and _METRIC_RE.match(node.value)
            and node.lineno not in skip_decl_lines
        ):
            out.append((node.value, node.lineno))
    return out


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
class MetricCatalog(Analyzer):
    name = RULE
    per_file = False
    description = (
        "raytpu_* metric names, chaos points, and flight-recorder kind "
        "prefixes must round-trip with their declaring catalogs"
    )

    def check_tree(self, ctxs: Sequence[FileContext]) -> Iterable[Finding]:
        by_path = {c.path: c for c in ctxs}
        findings: List[Finding] = []

        metrics_ctx = by_path.get(METRICS_PATH)
        chaos_ctx = by_path.get(CHAOS_PATH)
        flight_ctx = by_path.get(FLIGHT_PATH)
        # Partial-tree invocations (linting one file) skip catalog checks
        # whose declaring module is absent.
        declared = declared_metrics(metrics_ctx) if metrics_ctx else {}
        points = declared_chaos_points(chaos_ctx) if chaos_ctx else set()
        prefixes = declared_kind_prefixes(flight_ctx) if flight_ctx else set()

        decl_lines = {ln for (_v, ln) in declared.values()}
        used_names: Set[str] = set()
        point_sites: Dict[str, int] = {}

        for ctx in ctxs:
            skip = decl_lines if ctx.path == METRICS_PATH else set()
            for name, lineno in _metric_literals(ctx, skip):
                base = name
                for suf in _EXPO_SUFFIXES:
                    if name.endswith(suf) and name[: -len(suf)] in declared:
                        base = name[: -len(suf)]
                        break
                if declared and base not in declared:
                    # A strict prefix of a declared name = dynamic
                    # construction (f"raytpu_x_{axis}"); accept.
                    if any(d.startswith(name) for d in declared):
                        used_names.update(d for d in declared if d.startswith(name))
                        continue
                    if ctx.suppressed(RULE, lineno):
                        continue
                    findings.append(ctx.finding(
                        RULE, lineno,
                        f"metric name {name!r} is not declared in "
                        f"{METRICS_PATH} metric_defs",
                    ))
                else:
                    used_names.add(base)

            # Single-hop wrappers: a local function whose first parameter is
            # forwarded as the point to maybe_inject (channel.py's
            # _apply_channel_chaos) makes calls-with-a-literal injection
            # sites too.
            inject_fns = {"maybe_inject", "_chaos_inject"}
            for fn in ast.walk(ctx.tree):
                if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                params = [a.arg for a in fn.args.args]
                if not params:
                    continue
                for call in ast.walk(fn):
                    if (
                        isinstance(call, ast.Call)
                        and _call_literal(call, inject_fns) == ""
                        and isinstance(call.func, ast.Name)
                        and call.func.id in {"maybe_inject", "_chaos_inject"}
                        and call.args
                        and isinstance(call.args[0], ast.Name)
                        and call.args[0].id == params[0]
                    ):
                        inject_fns = inject_fns | {fn.name}
                        break
            for node in ast.walk(ctx.tree):
                if not isinstance(node, ast.Call):
                    continue
                pt = _call_literal(node, inject_fns)
                if pt and ctx.path != CHAOS_PATH:
                    if points and pt not in points:
                        if not ctx.suppressed(RULE, node.lineno):
                            findings.append(ctx.finding(
                                RULE, node.lineno,
                                f"chaos point {pt!r} not declared in "
                                f"{CHAOS_PATH} POINT_ACTIONS",
                            ))
                    else:
                        point_sites[pt] = point_sites.get(pt, 0) + 1
                kind = _call_literal(node, _RECORD_FN_NAMES)
                if kind and prefixes and _KIND_RE.match(kind):
                    prefix = kind.split(".", 1)[0]
                    if prefix not in prefixes and not ctx.suppressed(RULE, node.lineno):
                        findings.append(ctx.finding(
                            RULE, node.lineno,
                            f"flight-recorder kind {kind!r} uses prefix "
                            f"{prefix!r} not declared in {FLIGHT_PATH} "
                            "KIND_PREFIXES",
                        ))

        # Reverse direction: declarations nothing uses. Var-name references
        # outside the declaring assignment also count as usage (the normal
        # path: modules import the instrument and call .inc()).
        if metrics_ctx:
            all_text = {c.path: c.text for c in ctxs}
            for mname, (var, lineno) in sorted(declared.items()):
                if mname in used_names:
                    continue
                pat = re.compile(rf"\b{re.escape(var)}\b")
                used = any(
                    pat.search(text)
                    for path, text in all_text.items()
                    if path != METRICS_PATH
                )
                if not used:
                    # Within the declaring module, any use besides the
                    # assignment itself (e.g. a helper recording it).
                    uses_here = len(pat.findall(metrics_ctx.text))
                    used = uses_here > 1
                if not used and not metrics_ctx.suppressed(RULE, lineno):
                    findings.append(metrics_ctx.finding(
                        RULE, lineno,
                        f"metric {mname!r} ({var}) is declared but never "
                        "recorded anywhere",
                    ))
        if chaos_ctx:
            for pt in sorted(points):
                if point_sites.get(pt, 0) == 0:
                    findings.append(chaos_ctx.finding(
                        RULE, 1,
                        f"chaos point {pt!r} is declared in POINT_ACTIONS "
                        "but has no compiled-in injection site",
                    ))
        return findings
