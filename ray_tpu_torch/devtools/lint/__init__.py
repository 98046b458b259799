"""graft-lint over the PyTorch port: tools/lint's framework and seven of
its rules, pointed at `ray_tpu_torch/` (its catalogs, its control-plane
tick files, its CLI and its exception taxonomy). One entry point:

    python -m ray_tpu_torch.devtools.lint                # ray_tpu_torch/, baseline applied
    python -m ray_tpu_torch.devtools.lint --list-rules
    python -m ray_tpu_torch.devtools.lint path/to/file.py --no-baseline

Findings are `path:line: rule-id: message` (or --json), suppressible per
line with `# lint: disable=<rule>` (same line or the line above) or, for
silent-swallow, `# lint: swallow-ok(<reason>)`. The baseline
(baseline.json) is empty: every finding blocks. The JAX package's
import-safety rule has no copy here; tests/test_torch_imports.py is its
counterpart. Standard library only.
"""

from .framework import (  # noqa: F401
    Analyzer,
    FileContext,
    Finding,
    LintRun,
    load_baseline,
    registered,
    register,
)

# Importing the rules package populates the registry.
from . import rules  # noqa: F401  E402
