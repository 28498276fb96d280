"""Run reducers in-situ (over a live SstStream) or post-hoc (over a
BpReader series), plus the parity check that ties the two together.

The canonical wiring for "analyze live AND keep the data" is a teed stream:

    writer = AsyncBpWriter(path, n_ranks, cfg)
    stream = SstStream(queue_depth=2, tee=writer)
    rset   = ReducerSet([...])
    t      = attach_reducers(stream, rset)
    ... producer put()/end_step() loop ...
    stream.close(); t.join()
    live = rset.results()

and afterwards `reduce_posthoc(path, fresh_rset)` over the teed series must
equal `live` exactly — `assert_parity(live, posthoc)` is the guarantee.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Union

import numpy as np

from repro_torch.core.bp_engine import BpReader
from repro_torch.core.sst_engine import SstStream, attach_consumer
from repro_torch.insitu.reducers import ReducerSet


def attach_reducers(stream: SstStream, rset: ReducerSet,
                    *, daemon: bool = True) -> threading.Thread:
    """Consume the stream in a background thread, updating every reducer
    with each step as it arrives (in-situ: no filesystem in the loop)."""
    return attach_consumer(stream, rset.update, daemon=daemon)


def reduce_posthoc(series: Union[str, BpReader], rset: ReducerSet,
                   *, steps: Optional[list] = None,
                   parallel: Optional[int] = None) -> dict:
    """Replay a series on disk through the reducers, in sorted step order
    (the same order a live FIFO consumer observed). Only the variables the
    reducers declare in `needs` are read from the subfiles. `parallel=N`
    fans each variable's chunk reads over a ReaderPool; the default
    (None) leaves a caller-owned reader's own configured parallelism in
    charge. A reader WE open is managed as a context (pool + subfile
    handles released even when a reducer or a corrupt chunk raises
    mid-replay); a caller-owned reader is left open for the caller."""
    own = not isinstance(series, BpReader)
    cm = (BpReader(series, parallel=parallel or 0) if own
          else contextlib.nullcontext(series))
    needed = rset.needed_vars
    with cm as reader:
        for step in (reader.valid_steps() if steps is None else steps):
            names = reader.var_names(step)
            if needed is not None:
                names = [n for n in names if n in needed]
            rset.update(step, {n: reader.read_var(step, n, parallel=parallel)
                               for n in names})
    return rset.results()


def assert_parity(live: dict, posthoc: dict, path: str = "results",
                  atol: float = 0.0):
    """Equality of two reducer result trees; raises AssertionError naming
    the first diverging leaf. `atol=0` (default) demands exact, bitwise
    equality for arrays. A positive `atol` is parity-within-bounds: the
    contract when the teed series was stored through an error-bounded
    lossy codec ("lossy:<bound>") — post-hoc replay then reconstructs
    values within the codec bound, and so must every reduced scalar."""
    # explicit raises (not bare asserts): the documented AssertionError
    # contract must hold under `python -O` too
    if isinstance(live, dict) and isinstance(posthoc, dict):
        if live.keys() != posthoc.keys():
            raise AssertionError(
                f"{path}: keys {sorted(live)} != {sorted(posthoc)}")
        for k in live:
            assert_parity(live[k], posthoc[k], f"{path}/{k}", atol=atol)
        return
    if isinstance(live, np.ndarray) or isinstance(posthoc, np.ndarray):
        a, b = np.asarray(live), np.asarray(posthoc)
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{path}: arrays differ")
        if atol > 0.0 and a.dtype.kind == "f":
            if not np.allclose(a, b, rtol=0.0, atol=atol, equal_nan=True):
                err = float(np.nanmax(np.abs(
                    a.astype(np.float64) - b.astype(np.float64))))
                raise AssertionError(
                    f"{path}: arrays differ by {err:g} > atol={atol:g}")
        elif not np.array_equal(a, b, equal_nan=True):
            raise AssertionError(f"{path}: arrays differ")
        return
    if atol > 0.0 and isinstance(live, float) and isinstance(posthoc, float):
        if not (abs(live - posthoc) <= atol
                or (math.isnan(live) and math.isnan(posthoc))):
            raise AssertionError(
                f"{path}: {live!r} != {posthoc!r} (atol={atol:g})")
        return
    if live != posthoc:
        raise AssertionError(f"{path}: {live!r} != {posthoc!r}")
