"""jbprepack — rewrite a JBP (BP4) series at a new aggregator count,
optionally recompressing and restriping along the way.

The elastic-restart gap, closed: shards and subfiles are per-writer
artifacts, so a series written at W=8 was stuck at 8 subfiles forever.
Repack replays the committed steps through the chunk tables — per chunk,
a box read of exactly that chunk's extent (fanned out over a ReaderPool
with `--parallel`) and a `put()` under the SAME rank/offset — into a fresh
series with W′ aggregators, a different codec, or a different stripe
layout. Chunk structure (rank, offset, extent), per-chunk min/max
statistics, per-step attributes, dtypes and shapes are all preserved, so
the output is byte-equivalent UNDER THE READER: `read_var` returns
bit-identical arrays for every variable of every step. (The files
themselves differ — that is the point: new aggregation/codec/striping.)

    PYTHONPATH=src python -m repro_torch.tools.jbprepack SRC DST -w W' \
        [options]

Options:
    -w / --writers W'   aggregator count of the output series (required)
    --codec C           recompress with C (none|blosc|zlib|bzip2);
                        default: keep the source series' codec
    --stripe CxS        stripe each output subfile over C OSTs, S bytes
                        per stripe (e.g. 2x65536)
    --n-osts K          OST pool size for --stripe (default 4)
    --parallel N        ReaderPool workers for the chunk reads
    --workers K         writer-pool threads of the output engine
    --verify            re-read BOTH series afterwards and assert every
                        variable is bit-identical (the paranoid mode CI
                        uses)
    --force             overwrite DST if it exists
    --io-report         print this run's own Darshan counters to stderr

Torn/uncommitted steps of the source are dropped (only md.idx-committed
steps replay) — repack of a crashed series is also its repair.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import sys
import time
from typing import Optional

from repro_torch.core.bp_engine import BpReader, BpWriter, EngineConfig
from repro_torch.core.darshan import open_file
from repro_torch.core.striping import StripeConfig
from repro_torch.tools import _runner as R


def _source_codec(path: pathlib.Path) -> str:
    """Codec recorded in profiling.json, or 'none' for bare series."""
    p = path / "profiling.json"
    try:
        with open_file(p, "r") as f:
            return json.loads(f.read()).get("codec", "none")
    except (OSError, ValueError):
        return "none"


def _source_ranks(reader: BpReader) -> int:
    """The put()-rank space of the source: max rank in any chunk table + 1
    (the writer needs n_ranks only to validate puts and assign
    aggregators)."""
    hi = 0
    for step in reader.valid_steps():
        for name in reader.var_names(step):
            for ch in reader.iter_chunks(step, name):
                hi = max(hi, ch.rank)
    return hi + 1


def repack(src, dst, *, n_writers: int, codec: Optional[str] = None,
           stripe: Optional[StripeConfig] = None, n_osts: int = 4,
           parallel: int = 0, workers: int = 4,
           fsync_policy: str = "close") -> dict:
    """Rewrite `src` -> `dst` with W′=`n_writers` aggregators. Returns
    {steps, vars, chunks, bytes_read_raw, bytes_stored, wall_s}."""
    src = pathlib.Path(str(src))
    dst = pathlib.Path(str(dst))
    t0 = time.perf_counter()
    stats = {"steps": 0, "vars": 0, "chunks": 0, "bytes_raw": 0,
             "bytes_stored": 0}
    with BpReader(src, parallel=parallel) as reader:
        steps = reader.valid_steps()
        cfg = EngineConfig(
            aggregators=max(1, int(n_writers)),
            codec=codec if codec is not None else _source_codec(src),
            stripe=stripe, n_osts=n_osts, workers=workers,
            fsync_policy=fsync_policy)
        n_ranks = _source_ranks(reader) if steps else 1
        w = BpWriter(dst, n_ranks, cfg)
        try:
            for step in steps:
                w.begin_step(step)
                # per-step exactness: exactly what the source step
                # recorded, not this writer's accumulation so far
                w.replace_attributes(reader.attributes(step))
                names = reader.var_names(step)
                for name in names:
                    info = reader.var_info(step, name)
                    gshape = tuple(info["shape"])
                    # one full-array read per variable: the multi-chunk
                    # plan is what the ReaderPool parallelises; each
                    # chunk is then re-put as a slice of it, preserving
                    # the (rank, offset, extent) chunk structure exactly
                    full = reader.read_var(step, name)
                    for ch in reader.iter_chunks(step, name):
                        sl = tuple(slice(o, o + e) for o, e in
                                   zip(ch.offset, ch.extent))
                        w.put(name, full[sl], global_shape=gshape,
                              offset=ch.offset, rank=ch.rank)
                        stats["chunks"] += 1
                    stats["bytes_raw"] += full.nbytes
                prof = w.end_step()
                stats["bytes_stored"] += prof["bytes_stored"]
                stats["steps"] += 1
                stats["vars"] = max(stats["vars"], len(names))
        except BaseException:
            try:
                w.close()
            except BaseException:        # noqa: BLE001
                pass
            raise
        w.close()
    stats["wall_s"] = time.perf_counter() - t0
    return stats


class RepackMismatch(AssertionError):
    """The repacked series is NOT byte-equivalent under the reader."""


def verify_equivalent(src, dst, *, parallel: int = 0) -> int:
    """Verify byte-equivalence under the reader: every committed step of
    `src` exists in `dst` and every variable reads back bit-identical
    (including dtype). Raises `RepackMismatch` on any divergence —
    explicit raises, not `assert`, so `python -O` cannot silently turn
    the paranoid mode into a no-op. Returns the arrays compared."""
    n = 0
    with BpReader(src, parallel=parallel) as a, \
            BpReader(dst, parallel=parallel) as b:
        if a.valid_steps() != b.valid_steps():
            raise RepackMismatch(f"step sets differ: {a.valid_steps()} "
                                 f"vs {b.valid_steps()}")
        for step in a.valid_steps():
            if a.var_names(step) != b.var_names(step):
                raise RepackMismatch(f"step {step}: variable sets differ")
            if a.attributes(step) != b.attributes(step):
                raise RepackMismatch(f"step {step}: attributes differ")
            for name in a.var_names(step):
                x = a.read_var(step, name)
                y = b.read_var(step, name)
                if x.dtype != y.dtype or x.shape != y.shape:
                    raise RepackMismatch(
                        f"step {step} var {name!r}: {x.dtype}{x.shape} "
                        f"vs {y.dtype}{y.shape}")
                if x.tobytes() != y.tobytes():
                    raise RepackMismatch(
                        f"step {step} var {name!r} differs after repack")
                n += 1
    return n


def _parse_stripe(spec: str) -> StripeConfig:
    count, size = spec.lower().split("x", 1)
    return StripeConfig(stripe_count=int(count), stripe_size=int(size))


def main(argv=None) -> int:
    ap = R.make_parser(
        "jbprepack", "rewrite a JBP (BP4) series at a new aggregator "
        "count / codec / striping — byte-equivalent under the reader",
        parallel_flag=True)
    ap.add_argument("src", help="source <name>.bp4 directory")
    ap.add_argument("dst", help="destination directory (created)")
    ap.add_argument("-w", "--writers", type=int, required=True,
                    help="output aggregator count W'")
    ap.add_argument("--codec", default=None,
                    choices=("none", "blosc", "zlib", "bzip2"),
                    help="recompress with this codec (default: keep)")
    ap.add_argument("--stripe", default=None, metavar="CxS",
                    help="stripe output subfiles: COUNTxSIZE, e.g. 2x65536")
    ap.add_argument("--n-osts", type=int, default=4, dest="n_osts")
    ap.add_argument("--workers", type=int, default=4,
                    help="writer-pool threads of the output engine")
    ap.add_argument("--verify", action="store_true",
                    help="re-read both series and assert bit parity")
    ap.add_argument("--force", action="store_true",
                    help="overwrite DST if it exists")
    args = ap.parse_args(argv)

    err = R.check_series(args.src)
    if err is not None:
        print(f"jbprepack: {err}", file=sys.stderr)
        return R.EXIT_USAGE
    if args.writers < 1:
        print("jbprepack: -w must be >= 1", file=sys.stderr)
        return R.EXIT_USAGE
    dst = pathlib.Path(args.dst)
    if dst.exists():
        if not args.force:
            print(f"jbprepack: {dst} exists (use --force)", file=sys.stderr)
            return R.EXIT_USAGE
        shutil.rmtree(dst)
    try:
        stripe = _parse_stripe(args.stripe) if args.stripe else None
    except ValueError:
        print(f"jbprepack: bad --stripe {args.stripe!r} "
              f"(expected COUNTxSIZE, e.g. 2x65536)", file=sys.stderr)
        return R.EXIT_USAGE

    stats = repack(args.src, dst, n_writers=args.writers, codec=args.codec,
                   stripe=stripe, n_osts=args.n_osts,
                   parallel=args.parallel, workers=args.workers)
    mib = stats["bytes_raw"] / max(stats["wall_s"], 1e-9) / 2**20
    print(f"jbprepack: {args.src} -> {dst}  W'={args.writers}"
          f"{' codec=' + args.codec if args.codec else ''}"
          f"{' stripe=' + args.stripe if args.stripe else ''}")
    print(f"  {stats['steps']} steps, {stats['chunks']} chunks, "
          f"{stats['bytes_raw'] / 2**20:.1f} MiB raw -> "
          f"{stats['bytes_stored'] / 2**20:.1f} MiB stored, "
          f"{stats['wall_s']:.3f}s ({mib:.0f} MiB/s)")
    if args.verify:
        n = verify_equivalent(args.src, dst, parallel=args.parallel)
        print(f"  verify: {n} arrays bit-identical under the reader")
    if args.io_report:
        R.io_report("jbprepack")
    return R.EXIT_OK


if __name__ == "__main__":
    raise SystemExit(R.run_tool(main))
