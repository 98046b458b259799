"""Elastic compiled graphs: gang resize instead of gang death (the port of
ray_tpu/cgraph/elastic.py).

`CompiledGraph.recompile()` rebuilds the data plane against the same actor
set, the right recovery when `max_restarts` brings every member back. A
preemption that removes a node for good leaves the gang one actor short,
and a fixed-size graph can only raise ChannelClosed at it. `ElasticGraph`
is the gang-resize half (the Podracer assumption, arXiv:2104.06272: actor
gangs grow and shrink under the scheduler): the DAG is declared as a
function of the gang, so when members die the graph re-forms at the
surviving world size (collective edges re-bind their groups at the new
world through the normal compile path), and `grow()` folds replacement
actors back in at the caller's boundary (as TorchTrainer grows back at a
checkpoint).

    def build(actors):
        with InputNode() as inp:
            shards = [a.step.bind(inp) for a in actors]
            return MultiOutputNode(cgraph.allreduce.bind(shards))

    eg = cgraph.ElasticGraph(build, actors, min_actors=2)
    out = eg.run(batch)       # execute + get, resizing through deaths

Liveness is judged by the GCS actor table (state != DEAD), not by user
ping methods, so any gang works unmodified; a member the GCS still calls
RESTARTING is kept, and the wiring waits for it.
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Sequence

from .. import exceptions as exc
from ..core.channel import ChannelClosed
from ..observability.flight_recorder import record as _frec
from .compile import CompiledGraph, compile as _compile

# A gang break surfaces as ChannelClosed from the data plane OR as a
# typed actor/worker death from a control-plane call that raced the
# detection (e.g. execute() submitting against the dead incarnation).
_BREAK_ERRORS = (ChannelClosed, exc.ActorError, exc.WorkerCrashedError)


class GangTooSmallError(RuntimeError):
    """The surviving gang fell below `min_actors` — elasticity cannot
    absorb this loss; the caller must restore from a checkpoint at a
    different scale or fail the job."""

    def __init__(self, alive: int, min_actors: int):
        self.alive = alive
        self.min_actors = min_actors
        super().__init__(
            f"elastic gang shrank to {alive} live actor(s), below the "
            f"min_actors floor of {min_actors}"
        )


def _dead_actor_ids() -> set:
    """Actor ids the GCS has declared DEAD (terminal — restarting and
    alive members are both kept in the gang)."""
    try:
        from ..utils import state

        return {
            a["actor_id"] for a in state.list_actors() if a.get("state") == "DEAD"
        }
    except Exception:
        return set()


class ElasticGraph:
    def __init__(
        self,
        build_fn: Callable[[List[Any]], Any],
        actors: Sequence[Any],
        *,
        min_actors: int = 1,
        rebuild_timeout: float = 60.0,
        **compile_kwargs: Any,
    ):
        if not actors:
            raise ValueError("ElasticGraph needs at least one actor")
        self._build_fn = build_fn
        self._actors: List[Any] = list(actors)
        self._target: List[Any] = list(actors)
        self._min_actors = min_actors
        self._rebuild_timeout = rebuild_timeout
        self._compile_kwargs = dict(compile_kwargs)
        self._graph: CompiledGraph = _compile(
            build_fn(self._actors), **self._compile_kwargs
        )

    # ------------------------------------------------------------- introspect
    @property
    def world_size(self) -> int:
        return len(self._actors)

    @property
    def actors(self) -> List[Any]:
        return list(self._actors)

    @property
    def graph(self) -> CompiledGraph:
        return self._graph

    # --------------------------------------------------------------- resize
    def _survivors(self) -> List[Any]:
        dead = _dead_actor_ids()
        return [a for a in self._actors if a._actor_id.hex() not in dead]

    def _dead_members(self) -> List[Any]:
        dead = _dead_actor_ids()
        return [a for a in self._actors if a._actor_id.hex() in dead]

    def _rebuild(self, actors: List[Any]) -> None:
        old = len(self._actors)
        try:
            self._graph.teardown()
        except Exception:  # lint: swallow-ok(tearing down a broken graph before re-forming)
            pass
        self._actors = actors
        self._graph = _compile(self._build_fn(actors), **self._compile_kwargs)
        _frec("cgraph.elastic_resize", (old, len(actors)))

    def resize(self) -> int:
        """Re-forms the graph over the surviving gang members; returns the
        new world size. Raises GangTooSmallError below the floor."""
        alive = self._survivors()
        if len(alive) < self._min_actors:
            raise GangTooSmallError(len(alive), self._min_actors)
        self._rebuild(alive)
        return len(alive)

    def grow(self, new_actors: Sequence[Any]) -> int:
        """Folds replacement actors into the gang, capped at the ORIGINAL
        target size, and re-forms the graph — the caller picks the
        boundary (e.g. after a checkpoint), as TorchTrainer grows
        back at a checkpoint. Surplus replacements are ignored:
        a gang growing PAST its declared world would break every
        world-size assumption downstream (checkpoint shard counts,
        per-rank batch splits)."""
        merged = list(self._actors) + [
            a for a in new_actors if a not in self._actors
        ]
        merged = merged[: len(self._target)]
        self._rebuild(merged)
        return len(merged)

    # ---------------------------------------------------------------- drive
    def execute(self, *args: Any):
        return self._graph.execute(*args)

    def run(self, *args: Any, timeout: Optional[float] = None) -> Any:
        """execute + get with elastic recovery: on a gang break, drop the
        dead members, re-form at the surviving world size, and retry the
        SAME iteration. A get() TIMEOUT with a dead member counts as a
        break too — a collective edge that lost a rank WEDGES (the
        survivors block in the op) rather than closing a channel, so the
        timeout is often the first observable symptom. Bounded by
        rebuild_timeout overall."""
        deadline = time.monotonic() + self._rebuild_timeout
        last: Optional[BaseException] = None
        while time.monotonic() < deadline:
            try:
                return self._graph.execute(*args).get(timeout=timeout)
            except _BREAK_ERRORS as e:
                last = e
            except TimeoutError as e:
                if not self._dead_members():
                    raise  # genuinely slow, not a gang break
                last = e
            alive = self._survivors()
            if len(alive) < self._min_actors:
                raise GangTooSmallError(len(alive), self._min_actors) from last
            if len(alive) == len(self._actors):
                # Nothing died for good (e.g. a restarting member):
                # rewire at the same size after a short breather.
                time.sleep(0.2)
            try:
                self._rebuild(alive)
            except Exception as rebuild_err:  # noqa: BLE001
                last = rebuild_err
                time.sleep(0.25)
        raise RuntimeError(
            f"elastic graph could not recover within {self._rebuild_timeout}s"
        ) from last

    def teardown(self) -> None:
        self._graph.teardown()

    def __enter__(self) -> "ElasticGraph":
        return self

    def __exit__(self, *exc) -> bool:
        self.teardown()
        return False
