"""The openPMD / BP4-style I/O engine and Darshan-style monitoring of the
port — its own copy of the JAX package's host planes, with tensors in the
places where that package takes a jax.Array, including the multi-process
write plane (`parallel_engine`, `shm_transport`).

The names below load their module on first use, so importing one host
module (`repro_torch.core.dxt`, `darshan`, `metrics`) does not import the
engine, nor torch with it."""
import importlib

_HOME = {
    "BpReader": "bp_engine", "BpWriter": "bp_engine",
    "EngineConfig": "bp_engine", "MONITOR": "darshan",
    "DarshanMonitor": "darshan", "open_file": "darshan",
    "Iteration": "openpmd", "Mesh": "openpmd", "ParticleSpecies": "openpmd",
    "Record": "openpmd", "Series": "openpmd", "OstPool": "striping",
    "StripeConfig": "striping", "StripedFile": "striping",
}

__all__ = list(_HOME)


def __getattr__(name):
    if name not in _HOME:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_HOME[name]}"), name)
