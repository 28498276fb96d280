"""Streaming reduction framework for in-situ analysis (paper §VI future
work; the follow-up study arXiv:2406.19058 makes it explicit).

A `Reducer` consumes one step at a time — `update(step, vars)` where `vars`
is the step's assembled `{name: np.ndarray}` — and produces an accumulated
`result()`. The SAME reducer runs in two places:

  * live, attached to an `SstStream` consumer thread (in-situ: no
    filesystem in the loop, data reduced the moment the producer emits it —
    the scalability story of Huebl et al., arXiv:1706.00522), or
  * post-hoc, replayed over a `BpReader` series on disk.

Parity guarantee: every reducer here is a DETERMINISTIC function of the
(step, vars) sequence — accumulation is float64 in array order, histograms
are summed step by step — and both paths deliver identical arrays in
identical step order (the stream queue is FIFO; the reader replays
`valid_steps()` in sorted order; the JBP codecs are lossless). Therefore a
live run over a teed stream and a post-hoc run over the teed series produce
bit-identical results — `tests/test_insitu.py::test_parity_*` holds this.

Reducers tolerate missing variables (a step that doesn't carry `var` is
skipped), so mvstep/dmpstep-style mixed series reduce cleanly.
"""
from __future__ import annotations

from typing import Iterable, Optional

import numpy as np


class Reducer:
    """Protocol: update(step, vars) -> None, result() -> dict, reset()."""

    #: variables this reducer consumes; None means "needs every variable"
    #: (post-hoc runners use this to read only the needed bytes).
    needs: Optional[tuple] = None
    name: str = "reducer"

    def update(self, step: int, vars: dict) -> None:
        raise NotImplementedError

    def result(self) -> dict:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


class Moments(Reducer):
    """Particle moments of one variable: count, mean, variance, min/max.

    Exact accumulation (float64 sums of x and x^2 in array order) rather
    than a running mean — determinism is what makes the stream/post-hoc
    parity guarantee bitwise, not approximate.
    """

    def __init__(self, var: str, name: Optional[str] = None):
        self.var = var
        self.needs = (var,)
        self.name = name or f"moments({var})"
        self.reset()

    def reset(self):
        self._n = 0
        self._s1 = 0.0
        self._s2 = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None
        self._steps = 0

    def update(self, step, vars):
        arr = vars.get(self.var)
        if arr is None:
            return
        a = np.asarray(arr)
        if a.size == 0:
            return
        self._steps += 1
        self._n += int(a.size)
        self._s1 += float(np.sum(a, dtype=np.float64))
        self._s2 += float(np.sum(np.square(a, dtype=np.float64),
                                 dtype=np.float64))
        lo, hi = float(a.min()), float(a.max())
        self._min = lo if self._min is None else min(self._min, lo)
        self._max = hi if self._max is None else max(self._max, hi)

    def result(self):
        if self._n == 0:
            return {"n": 0, "steps": 0}
        mean = self._s1 / self._n
        var = max(self._s2 / self._n - mean * mean, 0.0)
        return {"n": self._n, "steps": self._steps, "mean": mean,
                "var": var, "std": var ** 0.5,
                "min": self._min, "max": self._max}


class Histogram(Reducer):
    """Accumulated histogram of a variable's values (energy / velocity
    distribution over the whole run). Fixed bin edges keep accumulation a
    plain float64 add — deterministic."""

    def __init__(self, var: str, bins: int = 64, range: tuple = (0.0, 1.0),
                 weight_var: Optional[str] = None, name: Optional[str] = None):
        self.var = var
        self.weight_var = weight_var
        self.bins = int(bins)
        self.range = (float(range[0]), float(range[1]))
        self.needs = (var,) if weight_var is None else (var, weight_var)
        self.name = name or f"hist({var})"
        self.reset()

    def reset(self):
        self._counts = np.zeros(self.bins, np.float64)
        self._steps = 0

    def update(self, step, vars):
        arr = vars.get(self.var)
        if arr is None:
            return
        a = np.asarray(arr).reshape(-1)
        w = None
        if self.weight_var is not None:
            w = vars.get(self.weight_var)
            if w is None:
                return
            w = np.asarray(w).reshape(-1)
        h, _ = np.histogram(a, bins=self.bins, range=self.range, weights=w)
        self._counts += h.astype(np.float64)
        self._steps += 1

    def result(self):
        edges = np.linspace(self.range[0], self.range[1], self.bins + 1)
        return {"counts": self._counts.copy(), "edges": edges,
                "steps": self._steps}


class PhaseSpace2D(Reducer):
    """Accumulated 2D phase-space histogram (e.g. x vs v_x) from two
    equal-length flat arrays."""

    def __init__(self, x_var: str, y_var: str, bins: tuple = (64, 64),
                 range: tuple = ((0.0, 1.0), (-1.0, 1.0)),
                 name: Optional[str] = None):
        self.x_var, self.y_var = x_var, y_var
        self.bins = (int(bins[0]), int(bins[1]))
        self.range = tuple((float(lo), float(hi)) for lo, hi in range)
        self.needs = (x_var, y_var)
        self.name = name or f"phasespace({x_var},{y_var})"
        self.reset()

    def reset(self):
        self._counts = np.zeros(self.bins, np.float64)
        self._steps = 0

    def update(self, step, vars):
        x, y = vars.get(self.x_var), vars.get(self.y_var)
        if x is None or y is None:
            return
        h, _, _ = np.histogram2d(np.asarray(x).reshape(-1),
                                 np.asarray(y).reshape(-1),
                                 bins=self.bins, range=self.range)
        self._counts += h.astype(np.float64)
        self._steps += 1

    def result(self):
        return {"counts": self._counts.copy(), "steps": self._steps}


class FieldEnergy(Reducer):
    """Per-step field energy time series: 0.5 * sum(field^2) * cell_volume."""

    def __init__(self, var: str, cell_volume: float = 1.0,
                 name: Optional[str] = None):
        self.var = var
        self.cell_volume = float(cell_volume)
        self.needs = (var,)
        self.name = name or f"field_energy({var})"
        self.reset()

    def reset(self):
        self._steps: list = []
        self._energy: list = []

    def update(self, step, vars):
        arr = vars.get(self.var)
        if arr is None:
            return
        a = np.asarray(arr)
        e = 0.5 * float(np.sum(np.square(a, dtype=np.float64),
                               dtype=np.float64)) * self.cell_volume
        self._steps.append(int(step))
        self._energy.append(e)

    def result(self):
        return {"steps": np.array(self._steps, np.int64),
                "energy": np.array(self._energy, np.float64)}


class SpeciesCount(Reducer):
    """Per-step weighted count time series (e.g. sum of a density profile
    times dx, or of a weighting record) — BIT1's particle-balance diagnostic."""

    def __init__(self, var: str, scale: float = 1.0,
                 name: Optional[str] = None):
        self.var = var
        self.scale = float(scale)
        self.needs = (var,)
        self.name = name or f"count({var})"
        self.reset()

    def reset(self):
        self._steps: list = []
        self._counts: list = []

    def update(self, step, vars):
        arr = vars.get(self.var)
        if arr is None:
            return
        self._steps.append(int(step))
        self._counts.append(
            float(np.sum(np.asarray(arr), dtype=np.float64)) * self.scale)

    def result(self):
        return {"steps": np.array(self._steps, np.int64),
                "counts": np.array(self._counts, np.float64)}


class ReducerSet:
    """A named bundle of reducers sharing one update stream."""

    def __init__(self, reducers: Iterable[Reducer]):
        self.reducers = list(reducers)
        names = [r.name for r in self.reducers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate reducer names {names} — results "
                             f"are keyed by name, so duplicates would "
                             f"silently overwrite each other")

    @property
    def needed_vars(self) -> Optional[set]:
        """Union of variables the set consumes; None when any reducer needs
        everything (post-hoc runners then read every variable)."""
        out: set = set()
        for r in self.reducers:
            if r.needs is None:
                return None
            out.update(r.needs)
        return out

    def update(self, step: int, vars: dict) -> None:
        for r in self.reducers:
            r.update(step, vars)

    def results(self) -> dict:
        return {r.name: r.result() for r in self.reducers}

    def reset(self) -> None:
        for r in self.reducers:
            r.reset()
