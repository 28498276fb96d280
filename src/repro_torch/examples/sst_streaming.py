"""In-situ streaming of the port (the paper's §VI future work): PIC
diagnostics flow producer->consumer through the SST-style engine, a
`repro_torch.insitu` ReducerSet analyzes them live while the simulation
keeps stepping, and a tee persists the same snapshots to a BP4 series. At
the end the post-hoc replay over `BpReader` must match the live reduction
EXACTLY (the insitu parity guarantee), and `jbpls` inspects the series
from metadata alone. Runs on the CUDA device by default.

    PYTHONPATH=src python -m repro_torch.examples.sst_streaming
    PYTHONPATH=src python -m repro_torch.examples.sst_streaming --device cpu
"""
import argparse
import pathlib
import tempfile

from repro_torch._device import resolve_device
from repro_torch.configs.bit1 import cpu_config
from repro_torch.core.async_engine import AsyncBpWriter
from repro_torch.core.bp_engine import EngineConfig
from repro_torch.core.sst_engine import SstStream
from repro_torch.insitu import (FieldEnergy, Moments, ReducerSet,
                                SpeciesCount, assert_parity, attach_reducers,
                                reduce_posthoc)
from repro_torch.pic.simulation import init_sim, run_with_diagnostics
from repro_torch.tools import jbpls


def make_reducers(cfg) -> ReducerSet:
    return ReducerSet([
        SpeciesCount("density/e", scale=cfg.dx, name="n_e"),
        SpeciesCount("density/D", scale=cfg.dx, name="n_D"),
        Moments("vdist/e", name="vdist_moments"),
        FieldEnergy("density/e", cell_volume=cfg.dx, name="e_field_energy"),
    ])


def main(argv=None) -> dict:
    """Runs the example; returns the live reducers' results."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=512,
                    help="paper-size divisor (100K cells / scale)")
    ap.add_argument("--chunks", type=int, default=6)
    ap.add_argument("--steps-per-chunk", type=int, default=100)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)      # no card: raise before any I/O

    cfg = cpu_config(args.scale)
    out = pathlib.Path(tempfile.mkdtemp(prefix="repro-torch-sst-")) \
        / "insitu.bp4"

    # producer -> stream -> {live reducers, tee -> async BP4 series}
    tee = AsyncBpWriter(out, n_ranks=4,
                        cfg=EngineConfig(aggregators=2, codec="blosc"))
    stream = SstStream(queue_depth=2, tee=tee)
    live = make_reducers(cfg)
    consumer = attach_reducers(stream, live)

    state = init_sim(cfg, 0, device=device)
    run_with_diagnostics(state, cfg, None, n_chunks=args.chunks,
                         steps_per_chunk=args.steps_per_chunk, stream=stream)
    stream.close()
    consumer.join(timeout=10)
    if consumer.is_alive() or consumer.error is not None:
        raise RuntimeError(f"in-situ consumer failed: {consumer.error}")

    # post-hoc replay over the teed series must match the live run exactly
    posthoc = reduce_posthoc(str(out), make_reducers(cfg))
    res = live.results()
    assert_parity(res, posthoc)

    n_e, n_D = res["n_e"]["counts"], res["n_D"]["counts"]
    for step, ne, nd in zip(res["n_e"]["steps"], n_e, n_D):
        print(f"  [live] step {step:5d}: n_e={ne:9.0f} n_D={nd:9.0f}")
    if not n_D[-1] < n_D[0]:
        raise AssertionError("neutrals should deplete")
    print(f"\nstreamed {len(n_e)} steps in-situ; neutral depletion "
          f"{n_D[0]:.0f} -> {n_D[-1]:.0f}; live == post-hoc (exact)\n")

    print("jbpls (metadata-only listing of the teed series):")
    jbpls.main([str(out), "-l", "-L"])
    return res


if __name__ == "__main__":
    main()
