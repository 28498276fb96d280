"""End-to-end driver of the port — the paper's own kind of workload: a
BIT1-style PIC-MC ionization simulation streaming diagnostics (.dat
analogue) and particle dumps (.dmp analogue) through openPMD + the JBP(BP4)
engine with aggregation + blosc compression, monitored by the Darshan
layer, with checkpoint/restart. Runs on the CUDA device by default.

    PYTHONPATH=src python -m repro_torch.examples.pic_simulation [--steps 2000]
    PYTHONPATH=src python -m repro_torch.examples.pic_simulation --device cpu \\
        --scale 1024 --steps 20 --mvstep 10 --dmpstep 10

`--device-compress` writes the checkpoints with the blosc codec and the
byte shuffle on the device (one bitshuffle launch a leaf).
"""
import argparse
import pathlib
import tempfile
import time

from repro_torch._device import resolve_device
from repro_torch.configs.bit1 import IO_KNOBS, cpu_config
from repro_torch.core import EngineConfig, Series
from repro_torch.core.darshan import MONITOR
from repro_torch.ckpt.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.pic.simulation import (PicState, diagnostics, init_sim,
                                        pic_run_chunk,
                                        write_diagnostics_openpmd,
                                        write_particle_dump_openpmd)


def main(argv=None) -> pathlib.Path:
    """Runs the example; returns its working directory (series + ckpt)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--mvstep", type=int, default=200,
                    help="diagnostic interval (paper: 1000)")
    ap.add_argument("--dmpstep", type=int, default=1000,
                    help="checkpoint interval (paper: 10000)")
    ap.add_argument("--scale", type=int, default=256,
                    help="paper-size divisor (100K cells / scale)")
    ap.add_argument("--n-io-ranks", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--device-compress", action="store_true",
                    help="blosc checkpoints, byte-shuffled on the device")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)      # no card: raise before any I/O

    workdir = pathlib.Path(tempfile.mkdtemp(prefix="repro-torch-pic-"))
    cfg = cpu_config(args.scale)
    print(f"BIT1 use case (scaled 1/{args.scale}): {cfg.n_cells} cells, "
          f"3 species x {cfg.n_electrons} particles, {args.steps} steps")
    print(f"I/O knobs: mvstep={args.mvstep} dmpstep={args.dmpstep} "
          f"(paper: {IO_KNOBS['mvstep']}/{IO_KNOBS['dmpstep']})")
    ckpt_cfg = (EngineConfig(aggregators=4, codec="blosc", workers=4)
                if args.device_compress else EngineConfig())

    MONITOR.reset()
    series = Series(workdir / "diag.bp4", "w", n_ranks=args.n_io_ranks,
                    engine_config=EngineConfig(aggregators=4, codec="blosc",
                                               workers=4))
    state = init_sim(cfg, 0, device=device)
    t0 = time.time()
    for start in range(0, args.steps, args.mvstep):
        n = min(args.mvstep, args.steps - start)
        state = pic_run_chunk(state, cfg, n)
        write_diagnostics_openpmd(series, state, cfg,
                                  n_io_ranks=args.n_io_ranks)
        if int(state.step) % args.dmpstep == 0:
            write_particle_dump_openpmd(series, state, cfg,
                                        n_io_ranks=args.n_io_ranks)
            save_checkpoint(workdir / "ckpt", state._asdict(),
                            int(state.step), n_io_ranks=args.n_io_ranks,
                            engine_config=ckpt_cfg,
                            device_compress=args.device_compress)
        series.flush()
        d = diagnostics(state, cfg)
        print(f"  step {int(state.step):6d}  e={d['count/e']:9.0f} "
              f"D+={d['count/D_plus']:9.0f} D={d['count/D']:9.0f} "
              f"ionized={d['ionizations']:9.0f}")
    series.close()
    wall = time.time() - t0

    # restart proof: restore the last checkpoint and continue 100 steps
    back, at = restore_checkpoint(workdir / "ckpt", state._asdict())
    restored = pic_run_chunk(PicState(**back), cfg, 100)
    print(f"restart from step {at} OK -> continued to {int(restored.step)}")

    rep = MONITOR.report(args.n_io_ranks)
    print(f"\nwall={wall:.1f}s  bytes_written="
          f"{rep['total']['POSIX_BYTES_WRITTEN']/2**20:.1f}MiB  "
          f"files={MONITOR.total_files_written()}")
    cost = MONITOR.cost_per_process(args.n_io_ranks)
    print(f"darshan per-process: read={cost['read_s']:.4f}s "
          f"write={cost['write_s']:.4f}s meta={cost['meta_s']:.4f}s")
    print(f"openPMD series: {workdir / 'diag.bp4'}")
    return workdir


if __name__ == "__main__":
    main()
