"""The openPMD / BP4-style I/O engine and Darshan-style monitoring of the
port — its own copy of the JAX package's host planes, with tensors in the
places where that package takes a jax.Array, including the multi-process
write plane (`parallel_engine`, `shm_transport`)."""
from repro_torch.core.bp_engine import BpReader, BpWriter, EngineConfig
from repro_torch.core.darshan import MONITOR, DarshanMonitor, open_file
from repro_torch.core.openpmd import (Iteration, Mesh, ParticleSpecies,
                                      Record, Series)
from repro_torch.core.striping import OstPool, StripeConfig, StripedFile

__all__ = [
    "BpReader", "BpWriter", "EngineConfig", "MONITOR", "DarshanMonitor",
    "open_file", "Iteration", "Mesh", "ParticleSpecies", "Record", "Series",
    "OstPool", "StripeConfig", "StripedFile",
]
