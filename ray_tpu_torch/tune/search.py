"""Search spaces and search algorithms.

Ref analogs: python/ray/tune/search/sample.py (Domain/Categorical/Float/
Integer, grid_search), python/ray/tune/search/basic_variant.py
(BasicVariantGenerator — grid cross-product x num_samples random draws),
python/ray/tune/search/search_algorithm.py. Re-designed small: a Domain is
a picklable sampler; variant generation is an explicit cross-product over
grid axes with independent random draws for stochastic axes.
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Dict, Iterator, List, Optional


class Domain:
    """A samplable hyperparameter axis."""

    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Categorical(Domain):
    def __init__(self, categories):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)

    def __repr__(self):
        return f"choice({self.categories})"


class Float(Domain):
    def __init__(self, lower: float, upper: float, log: bool = False,
                 q: Optional[float] = None):
        if log and lower <= 0:
            raise ValueError("loguniform requires lower > 0")
        self.lower, self.upper, self.log, self.q = lower, upper, log, q

    def sample(self, rng):
        if self.log:
            import math

            v = math.exp(rng.uniform(math.log(self.lower),
                                     math.log(self.upper)))
        else:
            v = rng.uniform(self.lower, self.upper)
        if self.q:
            v = round(v / self.q) * self.q
        return v

    def __repr__(self):
        return f"{'log' if self.log else ''}uniform({self.lower},{self.upper})"


class Integer(Domain):
    def __init__(self, lower: int, upper: int, q: int = 1):
        self.lower, self.upper, self.q = lower, upper, q

    def sample(self, rng):
        v = rng.randrange(self.lower, self.upper)
        return (v // self.q) * self.q

    def __repr__(self):
        return f"randint({self.lower},{self.upper})"


class GridSearch:
    """Marker for exhaustive axes (ref: tune/search/sample.py grid_search)."""

    def __init__(self, values):
        self.values = list(values)


def choice(categories) -> Categorical:
    return Categorical(categories)


def uniform(lower: float, upper: float) -> Float:
    return Float(lower, upper)


def loguniform(lower: float, upper: float) -> Float:
    return Float(lower, upper, log=True)


def quniform(lower: float, upper: float, q: float) -> Float:
    return Float(lower, upper, q=q)


def randint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper)


def qrandint(lower: int, upper: int, q: int) -> Integer:
    return Integer(lower, upper, q=q)


def grid_search(values) -> GridSearch:
    return GridSearch(values)


def sample_from(fn) -> "SampleFrom":
    return SampleFrom(fn)


class SampleFrom(Domain):
    """Callable domain: fn(spec: dict so-far) -> value."""

    def __init__(self, fn):
        self.fn = fn

    def sample(self, rng):  # resolved later with the partial config
        raise RuntimeError("SampleFrom is resolved by the generator")


# --------------------------------------------------------------- generation


def _split_space(space: Dict[str, Any], prefix=()):
    """Walk a (possibly nested-dict) space; yield (path, domain-or-literal)."""
    for k, v in space.items():
        path = prefix + (k,)
        if isinstance(v, dict):
            yield from _split_space(v, path)
        else:
            yield path, v


def _set_path(cfg: dict, path, value):
    d = cfg
    for k in path[:-1]:
        d = d.setdefault(k, {})
    d[path[-1]] = value


def generate_variants(space: Dict[str, Any], num_samples: int,
                      seed: Optional[int] = None) -> Iterator[Dict[str, Any]]:
    """Cross-product of grid axes × num_samples random draws.

    Matches the reference's semantics (basic_variant.py): each of the
    `num_samples` repetitions enumerates the full grid; stochastic axes are
    redrawn per variant.
    """
    rng = random.Random(seed)
    leaves = list(_split_space(space))
    grid_axes = [(p, v.values) for p, v in leaves if isinstance(v, GridSearch)]
    grid_iter = list(itertools.product(*[vals for _, vals in grid_axes])) \
        if grid_axes else [()]
    for _ in range(num_samples):
        for combo in grid_iter:
            cfg: Dict[str, Any] = {}
            for p, v in leaves:
                if isinstance(v, GridSearch):
                    continue
                if isinstance(v, SampleFrom):
                    continue  # second pass, needs partial config
                _set_path(cfg, p, v.sample(rng) if isinstance(v, Domain)
                          else v)
            for (p, _), val in zip(grid_axes, combo):
                _set_path(cfg, p, val)
            for p, v in leaves:
                if isinstance(v, SampleFrom):
                    _set_path(cfg, p, v.fn(cfg))
            yield cfg


class Searcher:
    """Suggestion-based search base (ref: tune/search/searcher.py).

    Subclasses propose configs one at a time and receive completed-trial
    feedback; wraps external optimizers.
    """

    def __init__(self, metric: str = None, mode: str = "max"):
        self.metric, self.mode = metric, mode

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str, result: Optional[dict] = None,
                          error: bool = False):
        pass


class BasicVariantGenerator(Searcher):
    """Default searcher: pre-expanded grid/random variants."""

    def __init__(self, space: Dict[str, Any], num_samples: int = 1,
                 seed: Optional[int] = None, **kw):
        super().__init__(**kw)
        self._variants = list(generate_variants(space, num_samples, seed))
        self._idx = 0

    @property
    def total(self) -> int:
        return len(self._variants)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._idx >= len(self._variants):
            return None
        cfg = self._variants[self._idx]
        self._idx += 1
        return cfg


class RandomSearch(Searcher):
    """Unbounded random sampler over a space (no grid axes)."""

    def __init__(self, space: Dict[str, Any], seed: Optional[int] = None,
                 **kw):
        super().__init__(**kw)
        self._space = space
        self._rng = random.Random(seed)

    def suggest(self, trial_id: str):
        cfg: Dict[str, Any] = {}
        for p, v in _split_space(self._space):
            if isinstance(v, GridSearch):
                v = Categorical(v.values)
            _set_path(cfg, p, v.sample(self._rng)
                      if isinstance(v, Domain) else v)
        return cfg


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator (Bergstra et al., NeurIPS 2011).

    Ref analog: the reference ships Bayesian-class searchers as wrappers
    (tune/search/hyperopt/hyperopt_search.py wraps hyperopt's TPE,
    tune/search/bayesopt, tune/search/optuna). Implemented natively here
    (no external optimizer dependency): completed trials are split into a
    good set (top ``gamma`` quantile by the objective) and a bad set; each
    candidate is drawn from the good set's Parzen density l(x) and ranked
    by the acquisition log l(x) - log g(x), factorized per axis.
    """

    def __init__(self, space: Dict[str, Any], *, metric: str = "reward",
                 mode: str = "max", n_initial_points: int = 10,
                 gamma: float = 0.25, n_candidates: int = 24,
                 seed: Optional[int] = None):
        super().__init__(metric=metric, mode=mode)
        self._leaves = list(_split_space(space))
        for p, v in self._leaves:
            if isinstance(v, SampleFrom):
                raise ValueError("TPESearcher does not support sample_from")
        self._rng = random.Random(seed)
        self._n_initial = n_initial_points
        self._gamma = gamma
        self._n_candidates = n_candidates
        self._live: Dict[str, Dict[str, Any]] = {}   # trial_id -> config
        self._observed: List[tuple] = []             # (config, score)

    # ------------------------------------------------------- observations

    def on_trial_complete(self, trial_id, result=None, error=False):
        cfg = self._live.pop(trial_id, None)
        if cfg is None or error or not result or \
                self.metric not in result:
            return
        score = float(result[self.metric])
        if self.mode == "min":
            score = -score
        self._observed.append((cfg, score))

    # --------------------------------------------------------- suggesting

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if len(self._observed) < self._n_initial:
            cfg = self._random_config()
        else:
            cfg = self._tpe_config()
        self._live[trial_id] = cfg
        return cfg

    def _random_config(self) -> Dict[str, Any]:
        cfg: Dict[str, Any] = {}
        for p, v in self._leaves:
            if isinstance(v, GridSearch):
                v = Categorical(v.values)
            _set_path(cfg, p, v.sample(self._rng)
                      if isinstance(v, Domain) else v)
        return cfg

    def _tpe_config(self) -> Dict[str, Any]:
        ranked = sorted(self._observed, key=lambda cv: cv[1], reverse=True)
        n_good = max(1, int(self._gamma * len(ranked)))
        good = [c for c, _ in ranked[:n_good]]
        bad = [c for c, _ in ranked[n_good:]] or good
        best_cfg, best_score = None, None
        for _ in range(self._n_candidates):
            cfg: Dict[str, Any] = {}
            total = 0.0
            for p, v in self._leaves:
                if isinstance(v, GridSearch):
                    v = Categorical(v.values)
                if not isinstance(v, Domain):
                    _set_path(cfg, p, v)
                    continue
                gv = [_get_path(c, p) for c in good]
                bv = [_get_path(c, p) for c in bad]
                val, logratio = self._propose_axis(v, gv, bv)
                _set_path(cfg, p, val)
                total += logratio
            if best_score is None or total > best_score:
                best_cfg, best_score = cfg, total
        return best_cfg

    def _propose_axis(self, dom: Domain, good: list, bad: list):
        import math

        if isinstance(dom, Categorical):
            cats = dom.categories
            pg = _cat_probs(cats, good)
            pb = _cat_probs(cats, bad)
            i = self._rng.choices(range(len(cats)), weights=pg, k=1)[0]
            return cats[i], math.log(pg[i]) - math.log(pb[i])
        # numeric (Float / Integer): Parzen windows in (log-)space
        is_int = isinstance(dom, Integer)
        lo, hi = float(dom.lower), float(dom.upper)
        log = getattr(dom, "log", False)
        tf = math.log if log else (lambda x: float(x))
        t_lo, t_hi = tf(lo), tf(hi)
        g = [tf(v) for v in good]
        b = [tf(v) for v in bad]
        bw_g = max((t_hi - t_lo) / max(math.sqrt(len(g)), 1.0), 1e-9)
        bw_b = max((t_hi - t_lo) / max(math.sqrt(len(b)), 1.0), 1e-9)
        center = self._rng.choice(g)
        x = min(max(self._rng.gauss(center, bw_g), t_lo), t_hi)
        logratio = _parzen_logpdf(x, g, bw_g) - _parzen_logpdf(x, b, bw_b)
        val = math.exp(x) if log else x
        if is_int:
            val = int(min(max(round(val), dom.lower), dom.upper - 1))
            q = getattr(dom, "q", 1) or 1
            val = (val // q) * q
        elif getattr(dom, "q", None):
            val = round(val / dom.q) * dom.q
        return val, logratio


def _get_path(cfg: dict, path):
    d = cfg
    for k in path:
        d = d[k]
    return d


def _cat_probs(cats, values):
    """Category probabilities with add-one smoothing."""
    counts = [1.0] * len(cats)
    index = {c if not isinstance(c, (list, dict)) else repr(c): i
             for i, c in enumerate(cats)}
    for v in values:
        key = v if not isinstance(v, (list, dict)) else repr(v)
        if key in index:
            counts[index[key]] += 1.0
    total = sum(counts)
    return [c / total for c in counts]


def _parzen_logpdf(x, centers, bw):
    import math

    # log-mean-exp of N(x; ci, bw) over centers
    logs = [-0.5 * ((x - c) / bw) ** 2 - math.log(bw) for c in centers]
    m = max(logs)
    return m + math.log(sum(math.exp(v - m) for v in logs)
                        / len(centers))
