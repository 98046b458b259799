"""AcceleratorManager: the per-accelerator-family detection/visibility ABC
(copy of ray_tpu/accelerators/accelerator.py for the PyTorch port).

Re-design of the reference's accelerator abstraction (reference:
python/ray/_private/accelerators/accelerator.py — the ABC every family
implements and node startup consults). Managers are instances, not static
namespaces, so probe inputs (the environment, a device counter) are
injectable and detection is testable without the device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


class AcceleratorManager:
    """Detection + process-visibility contract for one accelerator family.

    Node startup asks the registered managers how many accelerators the host
    has, the API which requests are valid, and the worker spawner what
    environment makes a child process see exactly a given subset."""

    # ------------------------------------------------------------ identity
    def get_resource_name(self) -> str:
        """The resource string this family schedules under ("GPU")."""
        raise NotImplementedError

    def get_visible_accelerator_ids_env_var(self) -> Optional[str]:
        """Env var restricting which accelerators a process sees
        (CUDA_VISIBLE_DEVICES for GPUs), or None."""
        return None

    # ----------------------------------------------------------- detection
    def get_current_node_num_accelerators(self) -> int:
        """How many accelerators of this family the host carries."""
        raise NotImplementedError

    def get_current_node_accelerator_type(self) -> Optional[str]:
        """The family-specific type string (a GPU's product name), or None
        when undetectable."""
        return None

    def get_current_node_additional_resources(self) -> Dict[str, float]:
        """Extra custom resources registration should carry (beyond the
        family's count resource)."""
        return {}

    # ---------------------------------------------------------- validation
    def validate_resource_request_quantity(
        self, quantity: float
    ) -> Tuple[bool, Optional[str]]:
        """Whether a task may request `quantity` of this resource: a fraction
        of one device shares it; more than one must be whole devices."""
        if quantity > 1 and not float(quantity).is_integer():
            return (
                False,
                f"{self.get_resource_name()} requests over 1 must be whole "
                f"numbers, got {quantity}",
            )
        return True, None

    # ---------------------------------------------------------- visibility
    def get_current_process_visible_accelerator_ids(self) -> Optional[List[str]]:
        """Accelerator ids this process is restricted to (parsed from the
        visibility env var), or None when unrestricted."""
        return None

    def set_current_process_visible_accelerators(self, ids: List[str]) -> None:
        """Restricts THIS process (mutates os.environ) to `ids`."""
        import os

        for k, v in self.worker_visibility_env(ids).items():
            os.environ[k] = v

    def worker_visibility_env(self, ids: List[str], **extra) -> Dict[str, str]:
        """Env vars a freshly spawned worker needs to see exactly `ids` (the
        raylet injects these at spawn)."""
        var = self.get_visible_accelerator_ids_env_var()
        if var is None:
            return {}
        return {var: ",".join(str(i) for i in ids)}
