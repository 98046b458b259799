"""Shared object-plane payload types (copy of
ray_tpu/core/object_transport.py for the PyTorch port).

Lives in its own module (never run as __main__) so instances pickle with a
stable qualified name across daemon processes: the raylet runs as
`python -m ray_tpu_torch.core.raylet`, where locally-defined classes would
pickle as __main__.* and fail isinstance checks in consumers.
"""

from __future__ import annotations


class StoredError:
    """Marker stored in place of a return value when a task fails; the
    consumer re-raises (errors ride the object plane, as in the reference's
    RayError objects in plasma)."""

    def __init__(self, error: BaseException, task_desc: str = ""):
        self.error = error
        self.task_desc = task_desc
