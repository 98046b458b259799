"""Search spaces and trial-config generation (copy of
ray_tpu/tune/search.py for the PyTorch port).

Re-design of the reference's tune.search (reference:
python/ray/tune/search/sample.py domains; basic_variant.py:189
BasicVariantGenerator for grid/random; searcher.py:21 Searcher ABC).
External searcher wrappers (Optuna/HyperOpt/...) are pluggable via the
same Searcher ABC but not bundled.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional


# ------------------------------------------------------------------ domains


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


@dataclass
class Categorical(Domain):
    categories: List[Any]

    def sample(self, rng):
        return rng.choice(self.categories)


@dataclass
class Float(Domain):
    lower: float
    upper: float
    log: bool = False
    q: Optional[float] = None

    def sample(self, rng):
        if self.log:
            v = math.exp(rng.uniform(math.log(self.lower), math.log(self.upper)))
        else:
            v = rng.uniform(self.lower, self.upper)
        if self.q:
            v = round(v / self.q) * self.q
        return v


@dataclass
class Integer(Domain):
    lower: int
    upper: int  # exclusive, like the reference's randint
    log: bool = False

    def sample(self, rng):
        if self.log:
            v = int(math.exp(rng.uniform(math.log(self.lower), math.log(self.upper - 1))))
            return max(self.lower, min(v, self.upper - 1))
        return rng.randrange(self.lower, self.upper)


@dataclass
class FunctionDomain(Domain):
    fn: Callable[[], Any]

    def sample(self, rng):
        return self.fn()


@dataclass
class GridSearch:
    values: List[Any]


def choice(categories: List[Any]) -> Categorical:
    return Categorical(list(categories))


def uniform(lower: float, upper: float) -> Float:
    return Float(lower, upper)


def loguniform(lower: float, upper: float) -> Float:
    return Float(lower, upper, log=True)


def quniform(lower: float, upper: float, q: float) -> Float:
    return Float(lower, upper, q=q)


def randint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper)


def lograndint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper, log=True)


def sample_from(fn: Callable[[], Any]) -> FunctionDomain:
    return FunctionDomain(fn)


def grid_search(values: List[Any]) -> GridSearch:
    return GridSearch(list(values))


# ---------------------------------------------------------------- searchers


class Searcher:
    """ABC (reference: tune/search/searcher.py:21)."""

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: Dict[str, Any]) -> None:
        pass

    def on_trial_complete(
        self, trial_id: str, result: Optional[Dict[str, Any]] = None, error: bool = False
    ) -> None:
        pass


class BasicVariantGenerator(Searcher):
    """Grid cross-product x num_samples random sampling
    (reference: tune/search/basic_variant.py:189)."""

    def __init__(self, param_space: Dict[str, Any], num_samples: int = 1, seed: Optional[int] = None):
        self._rng = random.Random(seed)
        self._variants = list(self._expand(param_space, num_samples))
        self._i = 0

    def _expand(self, space: Dict[str, Any], num_samples: int) -> Iterator[Dict[str, Any]]:
        grid_keys = [k for k, v in space.items() if isinstance(v, GridSearch)]

        def grid_product(idx: int, acc: Dict[str, Any]) -> Iterator[Dict[str, Any]]:
            if idx == len(grid_keys):
                yield dict(acc)
                return
            k = grid_keys[idx]
            for v in space[k].values:
                acc[k] = v
                yield from grid_product(idx + 1, acc)
                del acc[k]

        for _ in range(num_samples):
            for grid_combo in grid_product(0, {}):
                cfg = {}
                for k, v in space.items():
                    if isinstance(v, GridSearch):
                        cfg[k] = grid_combo[k]
                    elif isinstance(v, Domain):
                        cfg[k] = v.sample(self._rng)
                    else:
                        cfg[k] = v
                yield cfg

    @property
    def total_trials(self) -> int:
        return len(self._variants)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._i >= len(self._variants):
            return None
        cfg = self._variants[self._i]
        self._i += 1
        return cfg


class TPESearcher(Searcher):
    """Native Tree-structured Parzen Estimator.

    The reference ships model-based search by WRAPPING external libraries
    (reference: tune/search/hyperopt/, tune/search/optuna/ — both default
    to TPE samplers); none of those libraries is bundled here, so the
    sampler itself is built in. Algorithm: Bergstra et al., "Algorithms
    for Hyper-Parameter Optimization" (NeurIPS 2011) — split observations
    at the gamma-quantile into good/bad sets, model each with a kernel
    density per dimension, and suggest the candidate maximizing the
    good/bad density ratio. Pairing this with the ASHA scheduler gives a
    BOHB-shaped setup (model-based proposals + successive halving).
    """

    def __init__(
        self,
        param_space: Dict[str, Any],
        metric: str,
        mode: str = "min",
        num_samples: int = 64,
        n_startup_trials: int = 10,
        gamma: float = 0.25,
        n_candidates: int = 24,
        seed: Optional[int] = None,
    ):
        if mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        self._space = {
            k: (Categorical(list(v.values)) if isinstance(v, GridSearch) else v)
            for k, v in param_space.items()
        }
        self._metric = metric
        self._mode = mode
        self._rng = random.Random(seed)
        self._num_samples = num_samples
        self._n_startup = n_startup_trials
        self._gamma = gamma
        self._n_cand = n_candidates
        self._issued = 0
        self._live: Dict[str, Dict[str, Any]] = {}
        self._obs: List[tuple] = []  # (config, score-to-minimize)

    @property
    def total_trials(self) -> int:
        return self._num_samples

    # ------------------------------------------------------------- suggest
    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._issued >= self._num_samples:
            return None
        self._issued += 1
        if len(self._obs) < self._n_startup:
            cfg = {
                k: (v.sample(self._rng) if isinstance(v, Domain) else v)
                for k, v in self._space.items()
            }
        else:
            cfg = self._tpe_config()
        self._live[trial_id] = cfg
        return cfg

    def on_trial_complete(self, trial_id, result=None, error=False) -> None:
        cfg = self._live.pop(trial_id, None)
        if cfg is None or error or not result or self._metric not in result:
            return
        score = float(result[self._metric])
        if not math.isfinite(score):
            return  # a diverged trial (NaN/inf loss) must not poison the KDE
        if self._mode == "max":
            score = -score
        self._obs.append((cfg, score))

    # ------------------------------------------------------------ modeling
    def _tpe_config(self) -> Dict[str, Any]:
        ranked = sorted(self._obs, key=lambda o: o[1])
        n_good = max(1, int(math.ceil(self._gamma * len(ranked))))
        good = [c for c, _ in ranked[:n_good]]
        bad = [c for c, _ in ranked[n_good:]] or good
        cfg: Dict[str, Any] = {}
        for k, dom in self._space.items():
            if isinstance(dom, Categorical):
                cfg[k] = self._suggest_categorical(dom, [g[k] for g in good], [b[k] for b in bad])
            elif isinstance(dom, (Float, Integer)):
                cfg[k] = self._suggest_numeric(dom, [g[k] for g in good], [b[k] for b in bad])
            elif isinstance(dom, Domain):
                cfg[k] = dom.sample(self._rng)  # opaque sampler: no model
            else:
                cfg[k] = dom
        return cfg

    def _suggest_categorical(self, dom: Categorical, good: list, bad: list):
        def probs(values):
            # Laplace-smoothed frequencies over the category set.
            counts = {c: 1.0 for c in dom.categories}
            for v in values:
                counts[v] = counts.get(v, 1.0) + 1.0
            total = sum(counts.values())
            return {c: counts[c] / total for c in dom.categories}

        pg, pb = probs(good), probs(bad)
        best, best_ratio = None, -1.0
        for _ in range(self._n_cand):
            c = self._rng.choices(dom.categories, weights=[pg[c] for c in dom.categories])[0]
            ratio = pg[c] / pb[c]
            if ratio > best_ratio:
                best, best_ratio = c, ratio
        return best

    def _suggest_numeric(self, dom, good: list, bad: list):
        log = bool(getattr(dom, "log", False))
        lo, hi = float(dom.lower), float(dom.upper)
        to_x = (lambda v: math.log(v)) if log else (lambda v: float(v))
        lo_x, hi_x = to_x(lo), to_x(max(hi, lo + 1e-12))
        span = max(hi_x - lo_x, 1e-12)

        def kde(points):
            xs = [to_x(v) for v in points]
            n = len(xs)
            # Scott-style bandwidth from the SPREAD of the points (a
            # span-based bandwidth covers the whole domain and every
            # candidate lands on a boundary), floored so a tight cluster
            # still explores a little.
            mean = sum(xs) / n
            std = math.sqrt(sum((x - mean) ** 2 for x in xs) / max(n - 1, 1))
            bw = max(std * 1.06 * (n ** -0.2), span * 0.02)
            def density(x):
                # n point kernels + one uniform prior component over the
                # domain (hyperopt's prior-weighted mixture): the prior
                # keeps exploration alive once the good set clusters.
                pts = sum(
                    math.exp(-0.5 * ((x - m) / bw) ** 2) / (math.sqrt(2 * math.pi) * bw)
                    for m in xs
                )
                return (pts + 1.0 / span) / (n + 1) + 1e-12
            return xs, bw, density

        gxs, gbw, gdens = kde(good)
        _, _, bdens = kde(bad)
        best_x, best_ratio = None, -1.0
        for _ in range(self._n_cand):
            # Sample from the good mixture (each point kernel or the prior
            # equally likely), truncated to the domain by rejection
            # (clamping would pile candidates on the bounds).
            if self._rng.random() < 1.0 / (len(gxs) + 1):
                x = self._rng.uniform(lo_x, hi_x)
            else:
                for _try in range(10):
                    x = self._rng.gauss(self._rng.choice(gxs), gbw)
                    if lo_x <= x <= hi_x:
                        break
                else:
                    x = self._rng.uniform(lo_x, hi_x)
            ratio = gdens(x) / bdens(x)
            if ratio > best_ratio:
                best_x, best_ratio = x, ratio
        v = math.exp(best_x) if log else best_x
        if isinstance(dom, Integer):
            return max(dom.lower, min(int(round(v)), dom.upper - 1))
        if dom.q:
            v = round(v / dom.q) * dom.q
        return min(max(v, lo), hi)
