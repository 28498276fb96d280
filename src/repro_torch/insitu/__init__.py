"""In-situ analysis & rapid metadata extraction (paper §V/§VI; follow-up
study arXiv:2406.19058).

The port's own copy of the JAX package's `insitu` (numpy-only):
  * `repro_torch.insitu.reducers` — streaming reductions (moments,
    histograms, phase space, field energy, species counts) with a common
    `update(step, vars)/result()` protocol,
  * `repro_torch.insitu.runner` — the same reducers run live over an
    `SstStream` or post-hoc over a `BpReader`, with an exact-parity
    guarantee.
  * `repro_torch.tools.jbpls` — the metadata-only listing of a series
    (O(metadata), zero `data.*` reads).
"""
from repro_torch.insitu.reducers import (FieldEnergy, Histogram, Moments,
                                   PhaseSpace2D, Reducer, ReducerSet,
                                   SpeciesCount)
from repro_torch.insitu.runner import (assert_parity, attach_reducers,
                                 reduce_posthoc)

__all__ = [
    "Reducer", "ReducerSet", "Moments", "Histogram", "PhaseSpace2D",
    "FieldEnergy", "SpeciesCount", "attach_reducers", "reduce_posthoc",
    "assert_parity",
]
