"""The streaming-return observations a driver makes, shared by a driver inside
a cluster and a remote client (tests/test_torch_tcp_cluster.py runs them in
both, on both packages).

`observe(rt, bound_s, options=None, only_first=False)` iterates, placed by
`options` (default: on the node with the "joined" resource, half of it
each, so the actor and one task fit there at once): a task stream
of 5 items, an actor's stream of 3, a
stream that raises after its first item, and an endless stream cancelled
after its first item. Each `next()` runs in a thread bounded by `bound_s`;
one that does not return in time is recorded as "blocked" and ends that
stream (its thread stays parked on the call). With `only_first` only the
task stream's first step is taken. The remote functions are made inside
`observe`, so each package's pickler sends them by value.
"""

import sys
import threading
import time

from ray_tpu_torch.core import serialization

serialization.register_pickle_by_value(sys.modules[__name__])


def _bounded_next(it, bound_s):
    box = {}

    def run():
        try:
            box["ref"] = next(it)
        except BaseException as e:  # noqa: BLE001 - handed to the caller
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(bound_s)
    if t.is_alive():
        return "blocked", None
    if "err" in box:
        if isinstance(box["err"], StopIteration):
            return "end", None
        return "raised", box["err"]
    return "ref", box["ref"]


def _drain(rt, gen, bound_s, limit=50, cancel_after=None):
    """[item values..., then "end" | "blocked" | "raised <Type>: <msg>"]."""
    it = iter(gen)
    out = []
    while len(out) < limit:
        kind, val = _bounded_next(it, bound_s)
        if kind != "ref":
            out.append(kind if kind != "raised" else _error(val))
            return out
        try:
            out.append(rt.get(val, timeout=bound_s))
        except Exception as e:  # noqa: BLE001 - the error is the observation
            out.append(_error(e))
        if cancel_after is not None and len(out) == cancel_after:
            rt.cancel(gen._header_ref)
    return out


def _error(e):
    """The type and the first line of a task error's cause."""
    msg = str(e).strip().splitlines()[0] if str(e).strip() else ""
    return f"raised {type(e).__name__}: {msg[:60]}"


def observe(rt, bound_s, options=None, only_first=False):
    on_joined = {"resources": {"joined": 0.5}} if options is None else options

    @rt.remote(num_returns="streaming", **on_joined)
    def gen(n):
        for i in range(n):
            yield i * 10

    if only_first:
        return {"task": _drain(rt, gen.remote(5), bound_s, limit=1)}

    @rt.remote(num_returns="streaming", **on_joined)
    def bad():
        yield 1
        raise ValueError("boom")

    @rt.remote(num_returns="streaming", **on_joined)
    def endless():
        i = 0
        while True:
            time.sleep(0.05)
            yield i
            i += 1

    class Streamer:
        def stream(self, n):
            for i in range(n):
                yield i + 100

    # No CPU held for its life: the tasks after it fit beside it.
    actor = rt.remote(num_cpus=0, **on_joined)(Streamer).remote()
    out = {"task": _drain(rt, gen.remote(5), bound_s),
           "actor": _drain(rt, actor.stream.options(num_returns="streaming").remote(3), bound_s),
           "error": _drain(rt, bad.remote(), bound_s)}
    cancelled = _drain(rt, endless.remote(), bound_s, cancel_after=1)
    # Items the producer sealed before the cancel landed may come first: the
    # observation is the first item, what ended the items, and that they did.
    ended = next((x for x in cancelled[1:] if not isinstance(x, int)), None)
    out["cancel"] = [cancelled[0], ended, len(cancelled) < 50]
    rt.kill(actor)  # its share of the node goes back for the next driver
    return out
