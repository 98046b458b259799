"""A world of gloo ranks that stays up across a test file's cases
(tests/torch_parallel_worker.py is each rank's program).

    world = World(4, tmp_dir)
    outs = world.run("seq_attention", {"q": q, ...})   # one dict per rank
    world.close()

Every wait has a deadline: each rank's answer is read by a thread of its own
into a queue, and `run` fails the test when a rank has not answered within
`timeout` s (a hang, or a rank that died); the world is then torn down and
the next `run` starts a fresh one, so one broken case does not break the
others.
"""

import json
import os
import queue
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
START_TIMEOUT_S = 120
RUN_TIMEOUT_S = 120
CLOSE_TIMEOUT_S = 30


class World:
    def __init__(self, n: int, tmp_dir: Path):
        self.n, self.tmp_dir, self.procs, self.calls = n, Path(tmp_dir), [], 0

    def _start(self):
        url = f"file://{self.tmp_dir / f'rendezvous{self.calls}'}"
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]))
        self.logs = [self.tmp_dir / f"rank{r}.{self.calls}.log" for r in range(self.n)]
        self.procs, self.answers = [], []
        for r in range(self.n):
            with open(self.logs[r], "w") as log:
                p = subprocess.Popen([sys.executable, str(WORKER), str(r), str(self.n), url],
                                     cwd=ROOT, env=env, stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, stderr=log, text=True)
            answers = queue.Queue()
            threading.Thread(target=self._read, args=(p, answers), daemon=True).start()
            self.procs.append(p)
            self.answers.append(answers)

    @staticmethod
    def _read(proc, answers):
        for line in proc.stdout:
            if line.startswith("@@"):
                answers.put(line[2:].strip())
        answers.put("exited")

    def _tail(self, r: int) -> str:
        return self.logs[r].read_text()[-3000:]

    def run(self, scenario: str, inputs: dict, timeout: float = RUN_TIMEOUT_S):
        """Runs `scenario` on every rank with `inputs`; returns each rank's
        outputs."""
        if not self.procs:
            self._start()
            timeout += START_TIMEOUT_S
        self.calls += 1
        in_path = self.tmp_dir / f"in{self.calls}.npz"
        np.savez(in_path, **inputs)
        outs = [self.tmp_dir / f"out{self.calls}.{r}.npz" for r in range(self.n)]
        failed = None
        try:
            for p, out in zip(self.procs, outs):
                p.stdin.write(json.dumps({"scenario": scenario, "in": str(in_path),
                                          "out": str(out)}) + "\n")
                p.stdin.flush()
            for r, answers in enumerate(self.answers):
                try:
                    answer = answers.get(timeout=timeout)
                except queue.Empty:
                    answer = f"no answer within {timeout} s"
                if answer != "ok":
                    failed = f"rank {r}: {answer}\n{self._tail(r)}"
                    break
        except (BrokenPipeError, OSError) as e:
            failed = f"a rank is gone: {e}"
        if failed:
            self.close(kill=True)
            pytest.fail(f"{scenario}: {failed}")
        return [dict(np.load(out)) for out in outs]

    def close(self, kill: bool = False):
        for p in self.procs:
            if kill:
                p.kill()
            else:
                try:
                    p.stdin.close()
                except OSError:
                    pass
        for p in self.procs:
            try:
                p.wait(timeout=CLOSE_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=CLOSE_TIMEOUT_S)
        self.procs = []
