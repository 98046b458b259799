"""Trial schedulers: FIFO, ASHA, median stopping, PBT (copy of
ray_tpu/tune/schedulers.py for the PyTorch port).

Re-design of the reference's tune.schedulers (reference:
python/ray/tune/schedulers/trial_scheduler.py:13 TrialScheduler ABC;
async_hyperband.py:19 ASHA; median_stopping_rule.py; pbt.py:221 PBT).
Decisions are made per reported result; PBT additionally returns an
exploit directive (restore from a better trial's checkpoint with a
perturbed config) that the controller executes.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

CONTINUE = "CONTINUE"
STOP = "STOP"


@dataclass
class ExploitDirective:
    """PBT: restart this trial from `source_trial_id`'s checkpoint with
    `new_config`."""

    source_trial_id: str
    new_config: Dict[str, Any]


class TrialScheduler:
    def on_result(self, trial_id: str, result: Dict[str, Any]):
        """Returns CONTINUE, STOP, or an ExploitDirective."""
        return CONTINUE

    def on_complete(self, trial_id: str, result: Optional[Dict[str, Any]]) -> None:
        pass


class FIFOScheduler(TrialScheduler):
    pass


class AsyncHyperBandScheduler(TrialScheduler):
    """ASHA (reference: tune/schedulers/async_hyperband.py:19): rungs at
    grace_period * reduction_factor^k; a trial reaching a rung stops unless
    its metric is in the top 1/reduction_factor of results recorded there."""

    def __init__(
        self,
        metric: str,
        mode: str = "max",
        time_attr: str = "training_iteration",
        grace_period: int = 1,
        reduction_factor: int = 4,
        max_t: int = 100,
    ):
        if mode not in ("max", "min"):
            raise ValueError("mode must be 'max' or 'min'")
        self._metric = metric
        self._mode = mode
        self._time_attr = time_attr
        self._rf = reduction_factor
        self._max_t = max_t
        self._rungs: List[Tuple[int, Dict[str, float]]] = []
        t = grace_period
        while t < max_t:
            self._rungs.append((t, {}))
            t *= reduction_factor
        self._rungs.reverse()  # highest rung first, as in the reference

    def _value(self, result) -> Optional[float]:
        v = result.get(self._metric)
        return None if v is None else (float(v) if self._mode == "max" else -float(v))

    def on_result(self, trial_id: str, result: Dict[str, Any]):
        t = int(result.get(self._time_attr, 0))
        if t >= self._max_t:
            return STOP
        value = self._value(result)
        if value is None:
            return CONTINUE
        action = CONTINUE
        for milestone, recorded in self._rungs:
            if t < milestone or trial_id in recorded:
                continue
            recorded[trial_id] = value
            vals = sorted(recorded.values(), reverse=True)
            cutoff_idx = max(0, int(len(vals) / self._rf) - 1)
            cutoff = vals[cutoff_idx] if len(vals) >= self._rf else None
            if cutoff is not None and value < cutoff:
                action = STOP
            break  # only the highest applicable rung is consulted
        return action


class MedianStoppingRule(TrialScheduler):
    """(reference: tune/schedulers/median_stopping_rule.py): stop a trial
    whose best result so far is worse than the median of the running
    averages of completed/running trials at the same step."""

    def __init__(
        self,
        metric: str,
        mode: str = "max",
        time_attr: str = "training_iteration",
        grace_period: int = 1,
        min_samples_required: int = 3,
    ):
        self._metric = metric
        self._sign = 1.0 if mode == "max" else -1.0
        self._time_attr = time_attr
        self._grace = grace_period
        self._min_samples = min_samples_required
        self._histories: Dict[str, List[float]] = {}

    def on_result(self, trial_id: str, result: Dict[str, Any]):
        v = result.get(self._metric)
        t = int(result.get(self._time_attr, 0))
        if v is None:
            return CONTINUE
        self._histories.setdefault(trial_id, []).append(self._sign * float(v))
        if t < self._grace or len(self._histories) < self._min_samples:
            return CONTINUE
        means = {
            tid: sum(h) / len(h) for tid, h in self._histories.items() if h
        }
        med = sorted(means.values())[len(means) // 2]
        best = max(self._histories[trial_id])
        return STOP if best < med else CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT (reference: tune/schedulers/pbt.py:221): at each
    perturbation_interval, trials in the bottom quantile clone the
    checkpoint of a random top-quantile trial and continue with a
    perturbed config."""

    def __init__(
        self,
        metric: str,
        mode: str = "max",
        time_attr: str = "training_iteration",
        perturbation_interval: int = 4,
        hyperparam_mutations: Optional[Dict[str, Any]] = None,
        quantile_fraction: float = 0.25,
        resample_probability: float = 0.25,
        seed: Optional[int] = None,
    ):
        self._metric = metric
        self._sign = 1.0 if mode == "max" else -1.0
        self._time_attr = time_attr
        self._interval = perturbation_interval
        self._mutations = dict(hyperparam_mutations or {})
        self._quantile = quantile_fraction
        self._resample_p = resample_probability
        self._rng = random.Random(seed)
        self._scores: Dict[str, float] = {}
        self._configs: Dict[str, Dict[str, Any]] = {}
        self._last_perturb: Dict[str, int] = {}

    def register_config(self, trial_id: str, config: Dict[str, Any]) -> None:
        self._configs[trial_id] = dict(config)

    def _mutate(self, config: Dict[str, Any]) -> Dict[str, Any]:
        from .search import Domain

        out = dict(config)
        for key, spec in self._mutations.items():
            if self._rng.random() < self._resample_p:
                if isinstance(spec, Domain):
                    out[key] = spec.sample(self._rng)
                elif isinstance(spec, list):
                    out[key] = self._rng.choice(spec)
                elif callable(spec):
                    out[key] = spec()
            elif isinstance(out.get(key), (int, float)):
                factor = self._rng.choice([0.8, 1.2])
                out[key] = type(out[key])(out[key] * factor)
        return out

    def on_result(self, trial_id: str, result: Dict[str, Any]):
        v = result.get(self._metric)
        if v is not None:
            self._scores[trial_id] = self._sign * float(v)
        t = int(result.get(self._time_attr, 0))
        if t - self._last_perturb.get(trial_id, 0) < self._interval or len(self._scores) < 2:
            return CONTINUE
        self._last_perturb[trial_id] = t
        ranked = sorted(self._scores.items(), key=lambda kv: kv[1], reverse=True)
        k = max(1, int(len(ranked) * self._quantile))
        top = [tid for tid, _ in ranked[:k]]
        bottom = {tid for tid, _ in ranked[-k:]}
        if trial_id not in bottom or trial_id in top:
            return CONTINUE
        source = self._rng.choice(top)
        new_config = self._mutate(self._configs.get(source, self._configs.get(trial_id, {})))
        self._configs[trial_id] = new_config
        return ExploitDirective(source_trial_id=source, new_config=new_config)
