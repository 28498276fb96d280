#!/usr/bin/env python3
"""Design measurements of two kernels of the port on one NVIDIA GPU.

    python3 chip_variants.py

1. The deposit kernel (`src/repro_torch/csrc/deposit.cu`) built with
   clusters of 2 and of 4 blocks (`-DDEPOSIT_CLUSTER`), each held against
   the plain version and timed in turns (2, 4, 4, 2) at the PIC main
   path's shape: N = 2^25 particles on 100,000 cells.
2. The SSD scan's two kernels apart (`ssd_cb_kernel`,
   `ssd_chunk_scan_kernel`) at zamba2-2.7b's prefill shape.
3. `reduced_precision`: the serve path's teacher-forced logit gaps
   (`chip_smoke.run_serve_path`: the forward through the kernels against
   the one through the plain versions, the decode against the forward,
   and the noise floor of two plain forwards chunked otherwise) with
   cuBLAS's reduced-precision bf16 reductions allowed (PyTorch's default)
   and not (`torch.backends.cuda.matmul.
   allow_bf16_reduced_precision_reduction = False`), in turns (on, off,
   off, on), for zamba2-2.7b (batch 4, prompt 512) and qwen1.5-0.5b
   (batch 2, prompt 128), 8 new tokens each. The default is restored:
   the port changes no default.

    python3 chip_variants.py [deposit] [ssd] [reduced_precision]

(all three by default). Prints one JSON line. Needs a CUDA device and
nvcc; imports the port from `src/` beside it and the timing helpers and
serve path of `chip_smoke.py`.
"""
import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent


def build_deposit(cluster: int) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    from repro_torch.kernels.deposit.ops import _SIGNATURES
    out = _build.BUILD_DIR.parent / "variants" / f"libdeposit_c{cluster}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                    f"-DDEPOSIT_CLUSTER={cluster}", "-o", str(out),
                    str(_build.CSRC / "deposit.cu")], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in _SIGNATURES.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    return lib


#: (arch, batch, prompt, new tokens, max_seq) of the reduced-precision runs
REDUCED_PATHS = (("zamba2-2.7b", 4, 512, 8, 1024),
                 ("qwen1.5-0.5b", 2, 128, 8, 256))


def reduced_precision(torch, dev) -> dict:
    """arch -> one row a run (on, off, off, on): whether cuBLAS may reduce
    bf16 products in reduced precision, and the run's teacher-forced
    logit gaps."""
    from chip_smoke import run_serve_path, serve_config
    flags = torch.backends.cuda.matmul
    default = flags.allow_bf16_reduced_precision_reduction
    out = {}
    try:
        for arch, batch, prompt, new, max_seq in REDUCED_PATHS:
            rows = out[arch] = []
            for on in (True, False, False, True):
                flags.allow_bf16_reduced_precision_reduction = on
                res = run_serve_path(torch, dev, serve_config(arch),
                                     batch=batch, prompt=prompt, new=new,
                                     max_seq=max_seq)
                tf = res["teacher_forcing"]
                rows.append({"reduced_precision_reduction": on, **{
                    k: tf[k] for k in (
                        "max_abs_logit", "kernels_vs_plain_max_abs_diff",
                        "noise_floor_max_abs_diff", "max_abs_diff",
                        "kernels_equal_share", "equal_share")}})
                torch.cuda.empty_cache()
    finally:
        flags.allow_bf16_reduced_precision_reduction = default
    return {"default": default, "paths": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    every = ("deposit", "ssd", "reduced_precision")
    ap.add_argument("parts", nargs="*", metavar="part",
                    help=f"any of {', '.join(every)} (all by default)")
    parts = ap.parse_args().parts or list(every)
    if set(parts) - set(every):
        ap.error(f"unknown part(s) {sorted(set(parts) - set(every))}")
    import torch
    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    out = {"device": smi}
    if "deposit" in parts:
        out["deposit_N_2^25_100000_cells"] = deposit_clusters(torch, dev)
    if "ssd" in parts:
        out["ssd_b4_s512_h80_p64_n64_device_ms"] = ssd_kernels(torch, dev)
    if "reduced_precision" in parts:
        out["bf16_reduced_precision_reduction"] = reduced_precision(torch,
                                                                    dev)
    print(json.dumps(out))
    return 0


def deposit_clusters(torch, dev) -> dict:
    """The deposit at clusters of 2 and 4 blocks, timed in turns."""
    from chip_smoke import _deposit_inputs, device_ms, time_ms
    from repro_torch.kernels import _build
    from repro_torch.kernels.deposit.ref import deposit_ref
    n, n_cells = 1 << 25, 100_000
    dx = 1.0 / n_cells
    x, w, alive = _deposit_inputs(torch, dev, n, 1.0, 1234)
    ref = deposit_ref(x, w, alive, n_cells, dx)
    libs = {c: build_deposit(c) for c in (2, 4)}
    rho = torch.zeros(n_cells, device=dev)
    path = ctypes.c_int(0)

    def call(c):
        def fn(i):
            rho.zero_()
            rc = libs[c].jbp_deposit_cic(
                x.data_ptr(), w.data_ptr(), alive.data_ptr(), rho.data_ptr(),
                n, n_cells, dx, ctypes.byref(path), _build.stream_of(x))
            _build.check(rc, f"deposit cluster {c}")
        return fn

    deposit = {}
    for c in (2, 4, 4, 2):
        call(c)(0)
        torch.cuda.synchronize()
        rel = float((rho / dx - ref).abs().max() / ref.abs().max())
        if not rel < 1e-4 or path.value != 1:
            raise AssertionError(f"cluster {c}: rel {rel}, path {path.value}")
        row = deposit.setdefault(f"cluster_{c}", {"ms": [], "device_ms": [],
                                                  "rel": rel})
        row["ms"].append(time_ms(torch, call(c), 20))
        row["device_ms"].append(device_ms(torch, call(c), 10, "deposit_cic"))
        row["cells_limit"] = libs[c].jbp_deposit_cluster_cells()
    return deposit


def ssd_kernels(torch, dev) -> dict:
    """The SSD scan's two kernels' device ms apart."""
    from chip_smoke import device_ms, ssd_inputs
    from repro_torch.kernels.ssd_scan import ops as sops
    args = ssd_inputs(torch, dev, 4, 512, 80, 64, 64, 1)
    return {name: device_ms(torch, lambda i: sops.ssd_scan(*args), 10, name)
            for name in ("ssd_cb_kernel", "ssd_chunk_scan_kernel", "ssd_")}


if __name__ == "__main__":
    sys.exit(main())
