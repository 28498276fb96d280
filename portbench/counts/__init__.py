"""Operations and bytes of the work the per-layer metrics divide, from
shapes, and the peaks they divide by.

Peaks are one NVIDIA H100 SXM's data-sheet rates (dense, at 700 W), one
a precision; a share of a peak names the one it used. Bytes count each
input read once and each output written once, whatever a kernel reads
again; where the work depends on the data, what these inputs need.
"""
from __future__ import annotations

PEAK_FLOPS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12,
              "fp8": 1979e12}
PEAK_BYTES_PER_S = 3.35e12

#: bytes of one particle slot: x, w, alive float32 and v float32[3]
SLOT_BYTES = 4 + 12 + 4 + 4
#: FLOPs a live particle costs in one step: the free flight (a multiply,
#: an add, a remainder), its share of the deposit for e and D+ (a divide,
#: a floor, a subtract, two multiplies, two adds) and, for a neutral, the
#: ionization test (a divide, a multiply by R dt, a negate, an exp, a
#: subtract, a compare)
FLIGHT_FLOPS, DEPOSIT_FLOPS, IONIZE_FLOPS = 3, 7, 6


def least_seconds(flops: float, nbytes: float, precision: str = "fp32"):
    """The least time the chip could take: the larger of operations over
    the precision's peak and bytes over the memory's."""
    return max(flops / PEAK_FLOPS[precision], nbytes / PEAK_BYTES_PER_S)


def checkpoint_bytes(capacity: int) -> int:
    """The state's tensor leaves: x, v, w, alive of 3 species and the
    uint32[2] key."""
    return 3 * SLOT_BYTES * capacity + 8


def deposit(capacity: int, n_cells: int) -> dict:
    """One deposit call: x, w and alive of the species' slots read once,
    the grid written once."""
    return {"flops": DEPOSIT_FLOPS * capacity,
            "bytes": 12 * capacity + 4 * n_cells}


def pic_step(live: dict, events: float, n_cells: int) -> dict:
    """One PIC step of the paper's case, from the live particles a
    species (`live`: e, D_plus, D) and the ionizations in the step: every
    live particle's fields read once; its position written once; each
    ionization writes the neutral's alive flag and a new electron's and
    ion's slots; the two deposited grids written once and the electrons'
    read once by the ionization."""
    n = sum(live.values())
    flops = (FLIGHT_FLOPS * n + DEPOSIT_FLOPS * (live["e"] + live["D_plus"])
             + IONIZE_FLOPS * live["D"])
    nbytes = (SLOT_BYTES * n + 4 * n + events * (4 + 2 * SLOT_BYTES)
              + 3 * 4 * n_cells)
    return {"flops": flops, "bytes": nbytes}
