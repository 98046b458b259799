"""The port's invariant gate (ray_tpu_torch/devtools/lint/, the port's copy of
tools/lint over ray_tpu_torch/): tests/test_lint.py's twelve cases on the
copy, with port paths in the fixtures, and the tier-1 gate: `python -m
ray_tpu_torch.devtools.lint` exits 0 over ray_tpu_torch/ with its empty
baseline. The metric catalog round-trips both ways over the live tree: every
`raytpu_*` name the port references is declared, and every declared
instrument is recorded somewhere.

Each fixture also goes through the JAX package's rule (tools/lint) under
ray_tpu/<the same path>, and the two must give the same (rule, line)
findings; the per-file rules are held to the same over every source file of
the port.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from ray_tpu_torch.devtools.lint.framework import (  # noqa: E402
    FileContext,
    load_baseline,
    registered,
    run_lint,
    save_baseline,
)
from ray_tpu_torch.devtools.lint.rules.blocking_in_loop import BlockingInLoop  # noqa: E402
from ray_tpu_torch.devtools.lint.rules.lock_discipline import LockDiscipline  # noqa: E402
from ray_tpu_torch.devtools.lint.rules.metric_catalog import MetricCatalog  # noqa: E402
from ray_tpu_torch.devtools.lint.rules.no_print import NoPrint  # noqa: E402
from ray_tpu_torch.devtools.lint.rules.postmortem_trigger_catalog import (  # noqa: E402
    PostmortemTriggerCatalog,
)
from ray_tpu_torch.devtools.lint.rules.silent_swallow import SilentSwallow  # noqa: E402
from ray_tpu_torch.devtools.lint.rules.typed_raise import TypedRaise  # noqa: E402
from tools.lint.framework import FileContext as JaxFileContext  # noqa: E402
from tools.lint.framework import iter_py_files  # noqa: E402
from tools.lint.framework import registered as jax_registered  # noqa: E402
import tools.lint.rules  # noqa: E402,F401 - registers the JAX package's rules

BASELINE = os.path.join("ray_tpu_torch", "devtools", "lint", "baseline.json")


def _ctx(text: str, relpath: str = "ray_tpu_torch/fake_module.py") -> FileContext:
    """A FileContext for fixture source under a chosen repo-relative path
    (no file is written; the path only steers path-sensitive rules)."""
    return FileContext(os.path.join(REPO_ROOT, relpath), textwrap.dedent(text))


def _findings(analyzer, ctx):
    return [f for f in analyzer.check_file(ctx) if not ctx.suppressed(f.rule, f.line)]


def _jax_ctx(port_ctx: FileContext) -> JaxFileContext:
    """The same source under the JAX package's path: ray_tpu_torch/<p> is
    ray_tpu/<p>; a path outside the port stays as it is."""
    prefix = "ray_tpu_torch/"
    rel = port_ctx.path
    if rel.startswith(prefix):
        rel = "ray_tpu/" + rel[len(prefix):]
    return JaxFileContext(os.path.join(REPO_ROOT, rel), port_ctx.text)


def _keys(findings):
    return [(f.rule, f.line) for f in findings]


def _checked(analyzer, ctx):
    """The port rule's findings on `ctx`, held equal to those of the JAX
    package's rule of the same name on the same source."""
    got = _findings(analyzer, ctx)
    jax_ctx = _jax_ctx(ctx)
    want = _findings(jax_registered()[analyzer.name](), jax_ctx)
    assert _keys(got) == _keys(want), (ctx.path, _keys(got), _keys(want))
    return got


def _checked_tree(analyzer, ctxs):
    """check_tree of the port rule over `ctxs`, held equal to the JAX rule's
    over the same sources under ray_tpu/ paths."""
    got = list(analyzer.check_tree(ctxs))
    want = list(jax_registered()[analyzer.name]().check_tree([_jax_ctx(c) for c in ctxs]))
    assert _keys(got) == _keys(want), (_keys(got), _keys(want))
    return got


# ------------------------------------------------------------ registry
def test_registry_has_expected_rules():
    rules = registered()
    assert set(rules) == {
        "silent-swallow", "blocking-in-loop", "metric-catalog", "typed-raise",
        "lock-discipline", "no-print", "postmortem-trigger-catalog",
    }
    assert all(c.default_enabled for c in rules.values())
    # The JAX lint has the same rules, and import-safety besides.
    assert set(jax_registered()) - set(rules) == {"import-safety"}


# ------------------------------------------------------- silent-swallow
def test_silent_swallow_positive_and_suppressed():
    bad = _ctx("""
        def f():
            try:
                g()
            except Exception:
                pass
    """)
    assert len(_checked(SilentSwallow(), bad)) == 1

    marked = _ctx("""
        def f():
            try:
                g()
            except Exception:  # lint: swallow-ok(best-effort cleanup)
                pass
    """)
    assert _checked(SilentSwallow(), marked) == []

    logged = _ctx("""
        def f():
            try:
                g()
            except Exception:
                log.warning("g failed")
    """)
    assert _checked(SilentSwallow(), logged) == []

    narrow = _ctx("""
        def f():
            try:
                g()
            except OSError:
                pass
    """)
    assert _checked(SilentSwallow(), narrow) == []

    cont = _ctx("""
        def f(items):
            for i in items:
                try:
                    g(i)
                except Exception:
                    continue
    """)
    assert len(_checked(SilentSwallow(), cont)) == 1

    disabled = _ctx("""
        def f():
            try:
                g()
            except Exception:  # lint: disable=silent-swallow
                pass
    """)
    assert _checked(SilentSwallow(), disabled) == []

    # A noqa comment alone is no marker: it gives no reason the linter reads.
    noqa = _ctx("""
        def f():
            try:
                g()
            except Exception:  # noqa: BLE001 - best effort
                pass
    """)
    assert len(_checked(SilentSwallow(), noqa)) == 1


# ----------------------------------------------------- blocking-in-loop
def test_blocking_under_lock_flagged():
    bad = _ctx("""
        import time
        def f(self):
            with self._lock:
                time.sleep(1.0)
    """)
    got = _checked(BlockingInLoop(), bad)
    assert len(got) == 1 and "holding" in got[0].message

    ok = _ctx("""
        import time
        def f(self):
            with self._lock:
                x = 1
            time.sleep(1.0)
    """)
    assert _checked(BlockingInLoop(), ok) == []

    cv_wait = _ctx("""
        def f(self):
            with self._seal_cv:
                self._seal_cv.wait(1.0)
    """)
    assert _checked(BlockingInLoop(), cv_wait) == []


def test_sleep_in_tick_function_flagged_only_in_tick_files():
    src = """
        import time
        class S:
            def _monitor_loop(self):
                while not self._stop.is_set():
                    time.sleep(0.5)
    """
    for tick_file in ("ray_tpu_torch/core/raylet.py", "ray_tpu_torch/core/gcs.py",
                      "ray_tpu_torch/serve/controller.py"):
        assert len(_checked(BlockingInLoop(), _ctx(src, tick_file))) == 1, tick_file
    assert _checked(BlockingInLoop(), _ctx(src, "ray_tpu_torch/data/dataset.py")) == []
    # The JAX tree's tick files are not the port's.
    assert _findings(BlockingInLoop(), _ctx(src, "ray_tpu/core/raylet.py")) == []


# ------------------------------------------------------ lock-discipline
def test_lock_discipline_bare_acquire_and_double_acquire():
    bare = _ctx("""
        def f(self):
            self._lock.acquire()
            work()
            self._lock.release()
    """)
    got = _checked(LockDiscipline(), bare)
    assert len(got) == 1 and "bare" in got[0].message

    double = _ctx("""
        def f(self):
            with self._lock:
                with self._lock:
                    pass
    """)
    got = _checked(LockDiscipline(), double)
    assert len(got) == 1 and "double acquire" in got[0].message

    rlock_ok = _ctx("""
        def f(self):
            with self._rlock:
                with self._rlock:
                    pass
    """)
    assert _checked(LockDiscipline(), rlock_ok) == []

    different_fns = _ctx("""
        def f(self):
            with self._lock:
                pass
        def g(self):
            with self._lock:
                pass
    """)
    assert _checked(LockDiscipline(), different_fns) == []

    with_ok = _ctx("""
        def f(self):
            with self._lock:
                pass
    """)
    assert _checked(LockDiscipline(), with_ok) == []


# ----------------------------------------------------------- typed-raise
_FAKE_EXCEPTIONS = """
class RayTpuError(Exception):
    pass
class PlacementGroupError(RayTpuError, RuntimeError):
    pass
"""


def test_typed_raise_in_rpc_service():
    svc = _ctx("""
        class GcsService:
            def create_thing(self):
                raise RuntimeError("untyped")
            def fine(self):
                raise PlacementGroupError("typed")
            def _private(self):
                raise RuntimeError("not an RPC surface")
            def reraise(self, e):
                raise
        class NotAService:
            def create_thing(self):
                raise RuntimeError("not flagged")
    """, "ray_tpu_torch/core/fake_gcs.py")
    exc_ctx = _ctx(_FAKE_EXCEPTIONS, "ray_tpu_torch/exceptions.py")
    got = _checked_tree(TypedRaise(), [svc, exc_ctx])
    assert len(got) == 1
    assert "create_thing" in got[0].message and got[0].line == 4


# -------------------------------------------------------------- no-print
def test_no_print_rule():
    bad = _ctx("def f():\n    print('hi')\n")
    assert len(_checked(NoPrint(), bad)) == 1
    marked = _ctx("def f():\n    print('hi')  # console-output: banner\n")
    assert _checked(NoPrint(), marked) == []
    cli = _ctx("def f():\n    print('hi')\n", "ray_tpu_torch/scripts.py")
    assert _checked(NoPrint(), cli) == []
    outside = _ctx("def f():\n    print('hi')\n", "tools/whatever.py")
    assert _checked(NoPrint(), outside) == []
    # The JAX package's CLI is not the port's.
    jax_cli = _ctx("def f():\n    print('hi')\n", "ray_tpu/scripts.py")
    assert _findings(NoPrint(), jax_cli) == []


# --------------------------------------------------------- metric-catalog
def test_metric_catalog_self_check_live_tree():
    """The port's metric names, chaos points, flight-recorder kind prefixes
    and trigger kinds round-trip with their catalogs."""
    run = run_lint(paths=("ray_tpu_torch",),
                   rules=("metric-catalog", "postmortem-trigger-catalog"))
    assert run.findings == [], [f.render() for f in run.findings]


def test_metric_catalog_flags_undeclared_names():
    cat = MetricCatalog()
    metrics = _ctx("""
        class Counter:
            def __init__(self, *a, **k): pass
        DECLARED = Counter("raytpu_declared_total", "x")
    """, "ray_tpu_torch/utils/internal_metrics.py")
    user = _ctx("""
        NAME = "raytpu_not_declared_total"
        USED = "raytpu_declared_total"
        import DECLARED
    """, "ray_tpu_torch/fake_user.py")
    got = _checked_tree(cat, [metrics, user])
    assert len(got) == 1 and "raytpu_not_declared_total" in got[0].message

    # Reverse direction: declared but never recorded.
    lonely = _ctx("""
        class Counter:
            def __init__(self, *a, **k): pass
        DEAD = Counter("raytpu_dead_metric_total", "x")
    """, "ray_tpu_torch/utils/internal_metrics.py")
    got = _checked_tree(cat, [lonely])
    assert len(got) == 1 and "never recorded" in got[0].message


def test_postmortem_trigger_catalog_both_ways():
    catalog = _ctx("""
        TRIGGERS = {
            "node.dead": "declared and published",
            "never.fired": "declared, no publish site",
        }
    """, "ray_tpu_torch/observability/postmortem.py")
    user = _ctx("""
        def f(bus):
            bus.publish_trigger("node.dead")
            bus.publish_trigger("not.declared")
    """, "ray_tpu_torch/fake_user.py")
    got = _checked_tree(PostmortemTriggerCatalog(), [catalog, user])
    assert len(got) == 2
    assert any("'not.declared'" in f.message and f.line == 4 for f in got)
    assert any("'never.fired'" in f.message for f in got)


@pytest.mark.parametrize("rule", ["silent-swallow", "blocking-in-loop",
                                  "lock-discipline", "no-print"])
def test_per_file_rules_match_the_jax_lint_over_the_port(rule):
    """Every source file of the port, read by the port's rule under its own
    path and by the JAX lint's rule under ray_tpu/<the same path>: equal
    findings, unsuppressed ones included, so no rule drifted in the copy."""
    port_rule = registered()[rule]()
    files = iter_py_files([os.path.join(REPO_ROOT, "ray_tpu_torch")])
    assert len(files) > 100
    for path in files:
        with open(path, encoding="utf-8") as f:
            ctx = FileContext(path, f.read())
        jax_ctx = _jax_ctx(ctx)
        got = _keys(port_rule.check_file(ctx))
        want = _keys(jax_registered()[rule]().check_file(jax_ctx))
        assert got == want, (ctx.path, got, want)


# ---------------------------------------------------- baseline round-trip
def test_baseline_round_trip(tmp_path):
    pkg = tmp_path / "ray_tpu_torch_fixture"
    pkg.mkdir()
    f = pkg / "mod.py"
    f.write_text(textwrap.dedent("""
        def f():
            try:
                g()
            except Exception:
                pass
    """))
    run1 = run_lint(paths=(str(pkg),), rules=("silent-swallow",))
    assert len(run1.findings) == 1 and len(run1.new) == 1

    bpath = str(tmp_path / "baseline.json")
    save_baseline(bpath, run1.findings)
    run2 = run_lint(paths=(str(pkg),), rules=("silent-swallow",),
                    baseline=load_baseline(bpath))
    assert run2.new == [] and len(run2.baselined) == 1

    # New debt is not absorbed by the old baseline...
    f.write_text(f.read_text() + textwrap.dedent("""
        def h():
            try:
                g()
            except Exception:
                pass
    """))
    run3 = run_lint(paths=(str(pkg),), rules=("silent-swallow",),
                    baseline=load_baseline(bpath))
    assert len(run3.new) == 1 and len(run3.baselined) == 1

    # ...and fixed debt shows up as stale budget.
    f.write_text("def f():\n    pass\n")
    run4 = run_lint(paths=(str(pkg),), rules=("silent-swallow",),
                    baseline=load_baseline(bpath))
    assert run4.findings == [] and sum(run4.stale_baseline.values()) == 1


# ----------------------------------------------------------- the gate
def test_lint_gate_tree_is_clean():
    """Tier-1 gate: the port passes its linter with the committed baseline,
    which is empty."""
    assert load_baseline(os.path.join(REPO_ROOT, BASELINE)) == {}
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.devtools.lint", "--baseline", BASELINE],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "graft-lint OK (0 baselined" in proc.stdout, proc.stdout


def test_lint_cli_json_and_list_rules():
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.devtools.lint", "--list-rules"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0
    assert "silent-swallow" in proc.stdout and "postmortem-trigger-catalog" in proc.stdout

    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.devtools.lint", "--json", "--baseline", BASELINE],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    data = json.loads(proc.stdout)
    assert data["ok"] is True and data["new"] == [] and data["baselined"] == []
