"""Network-partition chaos: black-hole control-plane traffic between groups
of nodes (a copy of ray_tpu/chaos/net.py for the PyTorch port).

The kill and preempt points (controller.py) model machines that die. The
nastier failure is a machine that keeps running while the network between
it and the control plane is gone: its raylet misses heartbeats, the GCS
declares it dead and reschedules its actors, and when the partition heals
the zombie is still there, holding leases and serving actors. This module
makes that failure injectable:

- ``partition(groups, one_way=, heal_after=)`` (driver side) computes, for
  every process a group names (the GCS daemon, each raylet, the driver
  itself), the peer addresses it must stop talking to, and installs that
  spec in each over RPC (``chaos_partition``). Addresses are the endpoints
  the cluster already dials (``raylet_<node_id>.sock``, the GCS socket, or
  their tcp:// endpoints), so a spec needs no other identity.
- The per-process half (``install`` / ``blocked_addr`` / ``heal``) is read
  by the two injection sites in core/rpc.py's ``RpcClient``: a blocked
  two-way ``call`` raises RpcUnavailableError, a blocked one-way ``notify``
  vanishes, and a blocked connect behaves like packets dropped on the
  floor (the client's retry loop uses up its own deadline).
- ``heal_after`` stamps a self-heal deadline in every process, so a
  partition never outlives its spec even when the heal RPC is itself
  partitioned away. Specs stack: a second partition never lifts the first.

Installs and blocked sends are flight-recorded (``chaos.partition``,
``net.drop``, ``net.heal``) and counted (``raytpu_net_partitions_total``,
``raytpu_net_blocked_total``).
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from ..observability.flight_recorder import record as _flight_record
from ..observability.logs import get_logger

GCS = "gcs"
DRIVER = "driver"


class _PartitionState:
    """One installed spec: the address substrings it blocks, its self-heal
    deadline, and the addresses whose first blocked send was recorded (a
    partitioned heartbeat retries every tick; recording each drop would
    wash the ring)."""

    __slots__ = ("blocked", "heal_at", "spec_id", "recorded")

    def __init__(self, blocked: Tuple[str, ...], heal_at: Optional[float], spec_id: str):
        self.blocked = blocked
        self.heal_at = heal_at
        self.spec_id = spec_id
        self.recorded: Set[str] = set()


_lock = threading.Lock()
# spec_id -> state; None (not {}) when empty, so the rpc sites' armed check
# is one global load and a truth test.
_specs: Optional[Dict[str, _PartitionState]] = None


def active() -> bool:
    """The rpc sites' cheap armed check."""
    return _specs is not None


def install(blocked: Sequence[str], heal_after: Optional[float] = None,
            spec_id: str = "") -> str:
    """Arms THIS process: sends and connects to any address that contains
    one of the `blocked` substrings are black-holed until heal() or the
    deadline."""
    global _specs
    spec_id = spec_id or uuid.uuid4().hex[:8]
    heal_at = time.monotonic() + max(0.0, heal_after) if heal_after is not None else None
    with _lock:
        if _specs is None:
            _specs = {}
        _specs[spec_id] = _PartitionState(tuple(blocked), heal_at, spec_id)
    _flight_record("chaos.partition", (spec_id, tuple(b[-48:] for b in blocked)))
    from ..utils import internal_metrics as imet

    imet.NET_PARTITIONS.inc()
    get_logger("chaos").warning(
        "network partition %s installed: blocking %d peer address(es)%s", spec_id,
        len(blocked), f", self-heals in {heal_after:.1f}s" if heal_after else "")
    return spec_id


def heal(spec_id: str = "") -> bool:
    """Disarms one spec (with no spec_id, every spec) in this process; False
    when nothing matching was active."""
    global _specs
    healed: List[str] = []
    with _lock:
        if _specs is None:
            return False
        if spec_id:
            s = _specs.pop(spec_id, None)
            if s is not None:
                healed.append(s.spec_id)
        else:
            healed.extend(_specs)
            _specs.clear()
        if not _specs:
            _specs = None
    for sid in healed:
        _flight_record("net.heal", (sid,))
    return bool(healed)


def blocked_addr(addr: str) -> Optional[str]:
    """The matching blocked substring when `addr` is partitioned away from
    this process, else None. A spec past its deadline heals here: every
    process enforces its own clock."""
    specs = _specs
    if specs is None:
        return None
    now = time.monotonic()
    for s in list(specs.values()):
        if s.heal_at is not None and now >= s.heal_at:
            heal(s.spec_id)
            continue
        for sub in s.blocked:
            if sub in addr:
                return sub
    return None


def note_drop(addr: str, what: str) -> None:
    """Accounts one black-holed send or connect: counted always, recorded
    once per (spec, address)."""
    from ..utils import internal_metrics as imet

    imet.NET_BLOCKED.inc()
    specs = _specs
    if specs is None:
        return
    for s in list(specs.values()):
        if any(sub in addr for sub in s.blocked):
            if addr not in s.recorded:
                s.recorded.add(addr)
                _flight_record("net.drop", (what, addr[-48:]))
            return


class ChaosPartitionRpc:
    """The daemons' RPC surface for partitions, mixed into GcsService and
    RayletService (one definition, so the install contract cannot diverge
    between the two)."""

    def chaos_partition(self, blocked: List[str], heal_after: Optional[float] = None,
                        spec_id: str = "") -> bool:
        install(blocked, heal_after=heal_after, spec_id=spec_id)
        return True

    def chaos_heal(self, spec_id: str = "") -> bool:
        return heal(spec_id)


# ---------------------------------------------------------------- driver API
class Partition:
    """An installed partition: heal() tears it down everywhere the driver
    can still reach (the per-process heal_after deadline covers the rest)."""

    def __init__(self, spec_id: str, targets: List[Tuple[str, Any]], local: bool):
        self.spec_id = spec_id
        self._targets = targets  # (member, RpcClient) of the gcs and raylet installs
        self._local = local
        self.healed = False

    def heal(self) -> None:
        if self.healed:
            return
        if self._local:
            heal(self.spec_id)
        failed = []
        for kind, cli in self._targets:
            try:
                cli.call("chaos_heal", self.spec_id, timeout=10.0)
            except Exception:  # noqa: BLE001 - unreachable now; heal() again or the deadline
                failed.append((kind, cli))
        # Only a heal delivered everywhere closes the handle: without a
        # heal_after deadline an unreachable target must stay retryable.
        self._targets = failed
        self.healed = not failed
        if failed:
            get_logger("chaos").warning(
                "partition %s: heal undelivered to %d target(s); call heal() again",
                self.spec_id, len(failed))

    def __enter__(self) -> "Partition":
        return self

    def __exit__(self, *exc) -> bool:
        self.heal()
        return False


def _resolve_members(groups: Sequence[Sequence[str]],
                     runtime) -> Tuple[Dict[str, int], Dict[str, str]]:
    """member -> group index, and member -> the RPC address others dial."""
    node_socks = {n["NodeID"]: n["sock"] for n in runtime._gcs.call("list_nodes")}
    member_group: Dict[str, int] = {}
    member_addr: Dict[str, str] = {}
    for gi, group in enumerate(groups):
        for m in group:
            if m in member_group:
                raise ValueError(f"partition member {m!r} appears in two groups")
            member_group[m] = gi
            if m == GCS:
                member_addr[m] = runtime._gcs.path
            elif m == DRIVER:
                member_addr[m] = ""  # nothing dials the driver through an RpcClient
            else:
                sock = node_socks.get(m)
                if sock is None:
                    raise ValueError(f"partition member {m!r} is not a known node id "
                                     f"(known: {sorted(node_socks)}, or 'gcs'/'driver')")
                member_addr[m] = sock
    return member_group, member_addr


def partition(groups: Sequence[Sequence[str]], one_way: bool = False,
              heal_after: Optional[float] = None, runtime=None) -> Partition:
    """Partitions the cluster's control plane between `groups`.

    Members are node ids (as `state.list_nodes()` or `Cluster.add_node`
    give them), ``"gcs"`` or ``"driver"``. Traffic between members of
    different groups is black-holed; members named in no group keep full
    connectivity. ``one_way=True`` blocks only the first group's outbound
    edges. ``heal_after`` seconds stamps a self-heal deadline into every
    affected process; ``Partition.heal()`` heals early.

    ``partition([[node_id], ["gcs"]])`` isolates a node's raylet from the
    GCS while the driver and the node's workers stay connected: the zombie
    that the epoch fence exists for.
    """
    if runtime is None:
        from ..core.runtime_base import maybe_runtime

        runtime = maybe_runtime()
    if len(groups) < 2:
        raise ValueError("a partition needs at least two groups")
    if runtime is None or not hasattr(runtime, "_gcs"):
        raise RuntimeError("chaos.partition needs an initialized cluster runtime")
    member_group, member_addr = _resolve_members(groups, runtime)

    def edge_blocked(src: int, dst: int) -> bool:
        if src == dst:
            return False
        return src == 0 if one_way else True

    spec_id = uuid.uuid4().hex[:8]
    installs: List[Tuple[str, List[str]]] = []
    for m, gi in member_group.items():
        blocked = sorted({member_addr[peer] for peer, pgi in member_group.items()
                          if member_addr[peer] and edge_blocked(gi, pgi)})
        if blocked:
            installs.append((m, blocked))
    # Remote installs first (the driver must still reach every target), the
    # driver's own last.
    targets: List[Tuple[str, Any]] = []
    local_blocked: Optional[List[str]] = None
    try:
        for m, blocked in installs:
            if m == DRIVER:
                local_blocked = blocked
                continue
            if m == GCS:
                cli = runtime._gcs
            elif hasattr(runtime, "_raylet_for"):
                cli = runtime._raylet_for(member_addr[m])
            else:  # a remote client keeps no raylet clients of its own
                from ..core.rpc import RpcClient

                cli = RpcClient(member_addr[m])
            # Appended before the call: an install whose reply was lost may
            # still have been delivered, so the rollback heals it too.
            targets.append((m, cli))
            cli.call("chaos_partition", blocked, heal_after, spec_id, timeout=10.0)
    except Exception:
        for _m, cli in targets:
            try:
                cli.call("chaos_heal", spec_id, timeout=10.0)
            except Exception:
                pass  # lint: swallow-ok(rollback heal; the heal_after deadline is the backstop)
        raise
    if local_blocked is not None:
        install(local_blocked, heal_after=heal_after, spec_id=spec_id)
    return Partition(spec_id, targets, local_blocked is not None)
