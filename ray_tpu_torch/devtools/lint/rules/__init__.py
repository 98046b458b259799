"""graft-lint rule plugins. Importing this package registers every rule."""

from . import (  # noqa: F401
    blocking_in_loop,
    lock_discipline,
    metric_catalog,
    no_print,
    postmortem_trigger_catalog,
    silent_swallow,
    typed_raise,
)
