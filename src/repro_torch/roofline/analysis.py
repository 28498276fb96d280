"""Three-term roofline of a step from the counts of its trace
(`roofline.trace_analysis`): the port of the JAX package's
`repro/roofline/analysis.py`, with the same report and arithmetic, for
one NVIDIA H100 SXM a device.

    compute term    = per-device FLOPs / peak FLOP/s
    memory term     = per-device bytes / HBM bandwidth
    collective term = per-device traffic of the groups within one node /
                      NVLink bandwidth + that of the groups that span
                      nodes / InfiniBand bandwidth
    memory lower    = per-device bytes of the step's inputs and outputs /
                      HBM bandwidth

The constants are the H100 SXM's data-sheet peaks (NVIDIA H100 Tensor
Core GPU datasheet, SXM5 column; DGX H100 user guide for the node); the
reference's are a TPU's and are not used here. A node is NODE_GPUS GPUs
on one NVLink switch fabric, ranks numbered node by node: a collective
whose group spans nodes runs on the ring's slowest link, the GPU's
InfiniBand NIC (every group of the dry-run's 256- and 512-rank meshes
does: their 16-wide axes leave a node).

What the terms are not: the compute term divides every FLOP, fp32 and
pointwise ones too, by the bf16 tensor-core peak, and so is a lower
bound of the compute time; the memory term divides the unfused bytes of
`trace_analysis` (each op's inputs and outputs), an upper bound of the
traffic, so the largest term is no lower bound of the step's time. The
bytes of the step's inputs and outputs (`trace_analysis.io_bytes`) give
the memory term's lower bound, reported beside it (`memory_lower_s`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

#: dense bf16 tensor-core FLOP/s (989.4 TFLOPS without sparsity)
PEAK_FLOPS = 989e12
#: HBM3 bandwidth, bytes/s (3.35 TB/s)
HBM_BW = 3.35e12
#: NVLink 4, bytes/s a direction a GPU (900 GB/s both directions)
NVLINK_BW = 450e9
#: GPUs on one NVLink switch fabric (an HGX H100 8-GPU board)
NODE_GPUS = 8
#: InfiniBand NDR, bytes/s a direction a GPU (DGX H100: one ConnectX-7
#: 400 Gb/s NIC a GPU)
IB_BW = 50e9
#: HBM bytes a GPU (80 GB)
HBM_PER_DEVICE = 80e9


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    collective_by_kind: dict
    collective_op_counts: dict
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float                 # 6*N(*active)*D, global
    useful_flops_ratio: float          # model_flops / (flops_per_device*chips)
    mfu_bound: float                   # model_flops/(chips*peak)/max(term)
    arg_bytes_per_device: float = 0.0
    temp_bytes_per_device: float = 0.0
    fits_hbm: Optional[bool] = None
    product_flops_per_device: float = 0.0   # the products alone
    #: the part of collective_bytes_per_device whose groups span nodes
    collective_cross_node_bytes_per_device: float = 0.0
    #: the step's inputs and outputs once, and their time at HBM_BW: the
    #: lower bound of the memory term (memory_s is the unfused upper one)
    io_bytes_per_device: float = 0.0
    memory_lower_s: float = 0.0

    def to_dict(self):
        return dataclasses.asdict(self)


def tokens_for_shape(kind: str, seq: int, batch: int) -> int:
    if kind in ("train", "prefill"):
        return seq * batch
    return batch                                   # decode: 1 new token/seq


def model_flops(cfg, kind: str, seq: int, batch: int) -> float:
    n = cfg.n_active_params() if cfg.n_experts else cfg.n_params()
    d = tokens_for_shape(kind, seq, batch)
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * d


def build_report(*, arch, shape, mesh_name, n_devices, counts, cfg, kind,
                 seq, batch, mem_stats=None) -> RooflineReport:
    """`counts`: `trace_analysis.analyze`'s dict; `mem_stats`: a dict with
    `argument_bytes` and `temp_bytes` a device."""
    a = counts
    compute_s = a["flops_per_device"] / PEAK_FLOPS
    memory_s = a["hbm_bytes_per_device"] / HBM_BW
    cross = a.get("collective_traffic_cross_node", 0.0)
    collective_s = ((a["collective_traffic_per_device"] - cross) / NVLINK_BW
                    + cross / IB_BW)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, kind, seq, batch)
    total_flops = a["flops_per_device"] * n_devices
    ratio = mf / total_flops if total_flops else 0.0
    step_time = max(terms.values()) or 1.0
    mfu_bound = (mf / (n_devices * PEAK_FLOPS)) / step_time
    rep = RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, n_devices=n_devices,
        flops_per_device=a["flops_per_device"],
        hbm_bytes_per_device=a["hbm_bytes_per_device"],
        collective_bytes_per_device=a["collective_traffic_per_device"],
        collective_by_kind=a["collective_traffic_by_kind"],
        collective_op_counts=a["collective_op_counts"],
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=mf, useful_flops_ratio=ratio,
        mfu_bound=mfu_bound,
        product_flops_per_device=a.get("product_flops_per_device", 0.0),
        collective_cross_node_bytes_per_device=cross,
        io_bytes_per_device=a.get("io_bytes_per_device", 0.0),
        memory_lower_s=a.get("io_bytes_per_device", 0.0) / HBM_BW)
    if mem_stats is not None:
        rep.arg_bytes_per_device = float(mem_stats["argument_bytes"])
        rep.temp_bytes_per_device = float(mem_stats["temp_bytes"])
        rep.fits_hbm = (rep.arg_bytes_per_device + rep.temp_bytes_per_device
                        <= HBM_PER_DEVICE)
    return rep
