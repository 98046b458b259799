"""graft-lint CLI over the port: `python -m ray_tpu_torch.devtools.lint`.

Exit codes: 0 clean (or all findings baselined), 1 new findings,
2 internal/usage error (unparseable files count: the tree must parse).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .framework import (
    DEFAULT_PATHS,
    load_baseline,
    registered,
    run_lint,
    save_baseline,
)

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "baseline.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.devtools.lint",
        description="graft-lint: ray_tpu_torch runtime invariant checkers",
    )
    ap.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS),
                    help="files/dirs to lint (default: ray_tpu_torch/)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline JSON path (default: the package's baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report everything, ignore the baseline")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from current findings and exit 0")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run (default: all enabled)")
    ap.add_argument("--skip", default="",
                    help="comma-separated rule ids to skip")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output (all findings + verdict)")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for name, cls in sorted(registered().items()):
            suffix = "" if cls.default_enabled else "  [off-by-default]"
            print(f"{name:26s} {cls.description}{suffix}")
        return 0

    baseline = None
    if not args.no_baseline and not args.update_baseline and os.path.exists(args.baseline):
        baseline = load_baseline(args.baseline)

    run = run_lint(
        paths=args.paths,
        rules=[r.strip() for r in args.rules.split(",") if r.strip()] if args.rules else None,
        skip=[r.strip() for r in args.skip.split(",") if r.strip()],
        baseline=baseline,
    )

    if run.errors:
        for e in run.errors:
            print(f"error: {e}", file=sys.stderr)
        return 2

    if args.update_baseline:
        save_baseline(args.baseline, run.findings)
        print(f"baseline rewritten: {len(run.findings)} findings -> {args.baseline}")
        return 0

    if args.as_json:
        print(json.dumps({
            "new": [f.as_json() for f in run.new],
            "baselined": [f.as_json() for f in run.baselined],
            "stale_baseline": run.stale_baseline,
            "ok": not run.new,
        }, indent=1))
        return 1 if run.new else 0

    for f in run.new:
        print(f.render())
    if run.new:
        print(f"\ngraft-lint: {len(run.new)} new finding(s) "
              f"({len(run.baselined)} baselined).")
        print("Fix them, suppress with `# lint: disable=<rule>` (+ reason), "
              "or — only for deliberate debt — --update-baseline.")
        return 1
    msg = f"graft-lint OK ({len(run.baselined)} baselined finding(s) remain"
    if run.stale_baseline:
        fixed = sum(run.stale_baseline.values())
        msg += f"; {fixed} baselined entr(y/ies) no longer fire — prune with --update-baseline"
    print(msg + ")")
    return 0


if __name__ == "__main__":
    sys.exit(main())
