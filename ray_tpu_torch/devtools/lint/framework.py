"""graft-lint core (tools/lint/framework.py for the PyTorch port): file
contexts, suppressions, registry, baseline.

The framework walks the package, parses each file once, and hands the
shared ``FileContext`` to every registered per-file analyzer; whole-tree
analyzers (catalog cross-checks) run once over the full context list. Suppression and baseline handling live here so
every analyzer gets them for free and they behave identically across
rules.

Suppression syntax (same line or the line directly above the finding):

    # lint: disable=<rule>[,<rule>...]
    # lint: swallow-ok(<reason>)        (silent-swallow only; reason required)

Baseline: ``baseline.json`` maps fingerprint -> count. A fingerprint is
``rule|path|stripped source line`` — deliberately line-number-free so
unrelated edits moving code up or down don't invalidate the whole file's
entries. Findings that consume baseline budget are reported separately
from NEW findings; only new findings fail the run.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Type

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

_DISABLE_RE = re.compile(r"#\s*lint:\s*disable=([a-z0-9_,\- ]+)")
_SWALLOW_OK_RE = re.compile(r"#\s*lint:\s*swallow-ok\(([^)]+)\)")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # repo-relative, posix separators
    line: int
    message: str
    snippet: str  # stripped source line the finding anchors to

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}|{self.path}|{self.snippet}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule}: {self.message}"

    def as_json(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


class FileContext:
    """One parsed source file: text, lines, AST, comment directives."""

    def __init__(self, path: str, text: str):
        self.abspath = os.path.abspath(path)
        self.path = os.path.relpath(self.abspath, REPO_ROOT).replace(os.sep, "/")
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=self.path)
        # line -> set of rule names disabled there; "*" disables all.
        self._disabled: Dict[int, set] = {}
        # line -> swallow-ok reason
        self._swallow_ok: Dict[int, str] = {}
        self._scan_directives(text)

    def _scan_directives(self, text: str) -> None:
        # tokenize finds comments robustly (no false hits inside strings);
        # fall back to a line regex scan only if the file has tokenize
        # quirks (it shouldn't: ast.parse already succeeded).
        import io

        try:
            for tok in tokenize.generate_tokens(io.StringIO(text).readline):
                if tok.type != tokenize.COMMENT:
                    continue
                self._scan_comment(tok.start[0], tok.string)
        except tokenize.TokenError:
            for i, line in enumerate(self.lines, 1):
                if "#" in line:
                    self._scan_comment(i, line.split("#", 1)[1])

    def _scan_comment(self, lineno: int, comment: str) -> None:
        m = _DISABLE_RE.search(comment if comment.startswith("#") else "#" + comment)
        if m:
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            self._disabled.setdefault(lineno, set()).update(rules)
        m = _SWALLOW_OK_RE.search(comment)
        if m:
            self._swallow_ok[lineno] = m.group(1).strip()

    def suppressed(self, rule: str, line: int) -> bool:
        """A `# lint: disable=<rule>` on the finding's line or the line above."""
        for ln in (line, line - 1):
            rules = self._disabled.get(ln)
            if rules and (rule in rules or "*" in rules):
                return True
        return False

    def swallow_ok_reason(self, line: int) -> Optional[str]:
        """A `# lint: swallow-ok(<reason>)` on the line or the line above."""
        for ln in (line, line - 1):
            if ln in self._swallow_ok:
                return self._swallow_ok[ln]
        return None

    def source_line(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def finding(self, rule: str, line: int, message: str) -> Finding:
        return Finding(rule=rule, path=self.path, line=line, message=message,
                       snippet=self.source_line(line))


class Analyzer:
    """Base class for graft-lint rules.

    Per-file rules implement ``check_file(ctx)``; whole-tree rules (cross-
    file catalogs) implement ``check_tree(ctxs)``.
    ``default_enabled=False`` rules only run when named via --rules.
    """

    name: str = ""
    description: str = ""
    per_file: bool = True
    default_enabled: bool = True

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        return ()

    def check_tree(self, ctxs: Sequence[FileContext]) -> Iterable[Finding]:
        return ()


_REGISTRY: Dict[str, Type[Analyzer]] = {}


def register(cls: Type[Analyzer]) -> Type[Analyzer]:
    assert cls.name, f"{cls.__name__} must set a rule name"
    assert cls.name not in _REGISTRY, f"duplicate rule {cls.name}"
    _REGISTRY[cls.name] = cls
    return cls


def registered() -> Dict[str, Type[Analyzer]]:
    return dict(_REGISTRY)


# ---------------------------------------------------------------- walking

DEFAULT_PATHS = ("ray_tpu_torch",)
# The linter does not lint itself (tools/ lies outside the tree the JAX
# package's lint checks).
_EXCLUDE_DIRS = {"__pycache__", ".git", "_build", "devtools"}


def iter_py_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        p = os.path.join(REPO_ROOT, p) if not os.path.isabs(p) else p
        if os.path.isfile(p):
            out.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [d for d in dirnames if d not in _EXCLUDE_DIRS]
            for fname in sorted(filenames):
                if fname.endswith(".py"):
                    out.append(os.path.join(dirpath, fname))
    return sorted(out)


# ---------------------------------------------------------------- baseline

def load_baseline(path: str) -> Dict[str, int]:
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    entries = data.get("entries", {})
    return {str(k): int(v) for k, v in entries.items()}


def save_baseline(path: str, findings: Sequence[Finding]) -> None:
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.fingerprint] = counts.get(f.fingerprint, 0) + 1
    data = {
        "comment": (
            "graft-lint baseline: pre-existing debt, tracked without blocking. "
            "Regenerate with `python -m ray_tpu_torch.devtools.lint "
            "--update-baseline` ONLY after confirming the new entries are deliberate."
        ),
        "entries": {k: counts[k] for k in sorted(counts)},
    }
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=1, sort_keys=False)
        f.write("\n")
    os.replace(tmp, path)


@dataclasses.dataclass
class LintRun:
    findings: List[Finding]            # everything surfaced (not suppressed)
    new: List[Finding]                 # not covered by the baseline
    baselined: List[Finding]           # consumed baseline budget
    stale_baseline: Dict[str, int]     # budget that nothing consumed (fixed debt)
    errors: List[str]                  # unparseable files etc.


def run_lint(
    paths: Sequence[str] = DEFAULT_PATHS,
    rules: Optional[Sequence[str]] = None,
    skip: Sequence[str] = (),
    baseline: Optional[Dict[str, int]] = None,
) -> LintRun:
    selected: List[Analyzer] = []
    for name, cls in sorted(_REGISTRY.items()):
        if rules is not None:
            if name not in rules:
                continue
        elif not cls.default_enabled or name in skip:
            continue
        selected.append(cls())

    ctxs: List[FileContext] = []
    errors: List[str] = []
    for fpath in iter_py_files(paths):
        try:
            with open(fpath, encoding="utf-8") as f:
                text = f.read()
            ctxs.append(FileContext(fpath, text))
        except (OSError, SyntaxError, ValueError) as e:
            errors.append(f"{fpath}: {e!r}")

    # Suppression is applied centrally for BOTH kinds of rule, so
    # `# lint: disable=<rule>` behaves identically everywhere (whole-tree
    # rules need not remember to self-check).
    by_path = {c.path: c for c in ctxs}

    def live(f: Finding) -> bool:
        ctx = by_path.get(f.path)
        return ctx is None or not ctx.suppressed(f.rule, f.line)

    findings: List[Finding] = []
    for an in selected:
        if an.per_file:
            for ctx in ctxs:
                findings.extend(f for f in an.check_file(ctx) if live(f))
        else:
            findings.extend(f for f in an.check_tree(ctxs) if live(f))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))

    budget = dict(baseline or {})
    new: List[Finding] = []
    baselined: List[Finding] = []
    for f in findings:
        if budget.get(f.fingerprint, 0) > 0:
            budget[f.fingerprint] -= 1
            baselined.append(f)
        else:
            new.append(f)
    stale = {k: v for k, v in budget.items() if v > 0}
    return LintRun(findings=findings, new=new, baselined=baselined,
                   stale_baseline=stale, errors=errors)
