"""jbpfsck — O(metadata) integrity scan & repair for a JBP (BP4) series.

fsck for the log-structured layout: everything the tool decides is decided
from `md.idx`, `md.0`, the `md.<w>.shard` logs and FILE SIZES (stat) —
payload bytes are never read. Checks, in dependency order:

  * structural: md.idx record granularity (a trailing partial record is a
    torn index tail — the classic crash signature),
  * per step: md.0 blob bounds + crc + JSON validity (torn/corrupt steps),
    duplicate step ids,
  * chunk extents: every committed chunk's [file_offset, +nbytes) must lie
    within its subfile's on-disk size (plain stat; striped layouts via the
    stat-only `striping.logical_size_of`) — a truncated subfile makes the
    step inconsistent even though its metadata seals validate,
  * shards: each md.<w>.shard replays to its sealed prefix
    (`iter_shard_records`); torn tail bytes are reported, and sealed
    records for steps that never committed are flagged as orphaned
    prepares (normal after a coordinator crash — dead weight, not damage),
  * orphaned payload/metadata bytes: subfile or md.0 bytes beyond the last
    committed reference (the two-phase-commit residue).

`--repair` truncates/reseals to the LAST CONSISTENT STEP: md.idx and md.0
are cut back to the longest prefix of steps that validate AND whose chunk
extents fit, and torn shard tails are cut back to their sealed prefix.
`--trim` additionally drops orphaned payload bytes from plain subfiles.
Repair never touches payload bytes of committed steps.

`--deep` additionally walks every committed chunk's JBPC block headers
(`compression.iter_block_headers`): magic, codec id (incl. the lossy id
and its sub-header), flags (the pre-shuffled bit), and the length chain
must tile the chunk's payload exactly, and the summed raw sizes must
equal the chunk extent's dtype x shape byte count — all WITHOUT
decompressing a single block. This is the only mode that reads payload
bytes (headers of each block, via ranged reads through BpReader, so
striped subfiles work too).

    PYTHONPATH=src python -m repro_torch.tools.jbpfsck SERIES [--repair] \
        [--trim]
        [--deep] [--json] [--io-report]

Exit codes: 0 clean (or fully repaired), 1 issues found (or remain),
2 not a JBP series.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import sys
import zlib
from typing import Optional

from repro_torch.core.bp_engine import IDX_RECORD, IDX_SIZE
from repro_torch.core.darshan import open_file
from repro_torch.core.parallel_engine import SHARD_HDR
from repro_torch.core.striping import OstPool, StripeConfig, logical_size_of
from repro_torch.tools import _runner as R


def _subfile_size(path: pathlib.Path, agg: int) -> Optional[int]:
    """On-disk byte length of data.<agg> — plain stat, or the stat-only
    striped-layout recovery. None when the subfile does not exist at all."""
    plain = path / f"data.{agg}"
    if plain.exists():
        return plain.stat().st_size
    side = path / f"data.{agg}.stripe.json"
    osts = sorted(path.glob("ost*"))
    if not osts:
        return None
    if side.exists():
        with open_file(side, "r") as f:
            cfgd = json.loads(f.read())
        cfg = StripeConfig(cfgd["stripe_count"], cfgd["stripe_size"])
    else:
        objs = sorted(path.glob(f"ost*/data.{agg}.obj"))
        if not objs:
            return None
        cfg = StripeConfig(len(objs), 1 * 1024 * 1024)
    return logical_size_of(OstPool(path, len(osts)), f"data.{agg}", cfg)


def _sealed_shard_prefix(path: pathlib.Path, w: int) -> tuple[list, int]:
    """(sealed (step, record) list, sealed prefix BYTE length) of shard w —
    the same replay `iter_shard_records` does, but tracking the exact byte
    offset the sealed prefix ends at (what a tail truncation needs)."""
    with open_file(path / f"md.{w}.shard", "rb") as f:
        raw = f.read()
    sealed, off = [], 0
    while off + SHARD_HDR.size <= len(raw):
        step, ln, crc = SHARD_HDR.unpack_from(raw, off)
        blob = raw[off + SHARD_HDR.size:off + SHARD_HDR.size + ln]
        if len(blob) != ln or (zlib.crc32(blob) & 0xFFFFFFFF) != crc:
            break
        sealed.append((step, json.loads(blob)))
        off += SHARD_HDR.size + ln
    return sealed, off


def scan(path) -> dict:
    """One O(metadata) pass -> the full fsck report (JSON-serializable)."""
    path = pathlib.Path(str(path))
    issues: list[dict] = []
    notes: list[dict] = []
    with open_file(path / "md.idx", "rb") as f:       # instrumented reads:
        idx_raw = f.read()                            # --io-report sees them
    if (path / "md.0").exists():
        with open_file(path / "md.0", "rb") as f:
            md_raw = f.read()
    else:
        md_raw = b""

    tail = len(idx_raw) % IDX_SIZE
    if tail:
        issues.append({"kind": "torn-idx-tail", "bytes": tail,
                       "detail": f"md.idx ends in {tail} bytes of a partial "
                                 f"record (crash during seal)"})

    # ---- per-record validation + the consistent prefix -------------------
    records = []            # (step, off, ln, ok, why, parsed)
    seen: set[int] = set()
    for i in range(0, len(idx_raw) - IDX_SIZE + 1, IDX_SIZE):
        step, off, ln, crc, flags, t_ns, _, _ = IDX_RECORD.unpack_from(
            idx_raw, i)
        blob = md_raw[off:off + ln]
        ok, why, parsed = True, None, None
        if len(blob) != ln or (zlib.crc32(blob) & 0xFFFFFFFF) != crc:
            ok, why = False, "torn/corrupt md.0 blob (crc mismatch)"
        else:
            try:
                parsed = json.loads(blob)
            except ValueError:
                ok, why = False, "md.0 blob is not valid JSON"
        if ok and step in seen:
            ok, why = False, "duplicate step id in md.idx"
        if ok:
            seen.add(step)
        else:
            issues.append({"kind": "torn-step", "step": step, "detail": why})
        records.append((step, off, ln, ok, why, parsed))

    # ---- chunk extents vs subfile sizes ----------------------------------
    sizes: dict[int, Optional[int]] = {}
    max_end: dict[int, int] = {}
    for ri, (step, off, ln, ok, why, parsed) in enumerate(records):
        if not ok:
            continue
        bad = None
        for name, var in parsed.get("vars", {}).items():
            for ch in var["chunks"]:
                agg = ch["agg"]
                if agg not in sizes:
                    sizes[agg] = _subfile_size(path, agg)
                end = ch["foff"] + ch["nbytes"]
                sz = sizes[agg]
                if sz is None or end > sz:
                    bad = (f"chunk of {name!r} needs data.{agg}"
                           f"[..{end}] but subfile "
                           f"{'is missing' if sz is None else f'ends at {sz}'}")
                    break
                max_end[agg] = max(max_end.get(agg, 0), end)
            if bad:
                break
        if bad:
            issues.append({"kind": "orphaned-extent", "step": step,
                           "detail": bad})
            records[ri] = (step, off, ln, False, bad, parsed)

    # longest consistent PREFIX (repair truncates here)
    prefix = 0
    for step, off, ln, ok, why, parsed in records:
        if not ok:
            break
        prefix += 1
    committed = [r[0] for r in records if r[3]]

    # ---- orphaned bytes (dead weight, not damage) ------------------------
    md_end = max((off + ln for step, off, ln, ok, *_ in records if ok),
                 default=0)
    if len(md_raw) > md_end:
        notes.append({"kind": "orphan-md-bytes",
                      "bytes": len(md_raw) - md_end,
                      "detail": "md.0 bytes beyond the last committed "
                                "record (uncommitted/torn steps)"})
    for agg, sz in sorted(sizes.items()):
        if sz is not None and sz > max_end.get(agg, 0):
            notes.append({"kind": "orphan-payload", "agg": agg,
                          "bytes": sz - max_end.get(agg, 0),
                          "detail": f"data.{agg} holds "
                                    f"{sz - max_end.get(agg, 0)} bytes no "
                                    f"committed chunk references"})

    # ---- shards ----------------------------------------------------------
    shards = []
    for p in sorted(path.glob("md.*.shard")):
        m = re.fullmatch(r"md\.(\d+)\.shard", p.name)
        if not m:
            continue
        w = int(m.group(1))
        sealed, sealed_len = _sealed_shard_prefix(path, w)
        size = p.stat().st_size
        if size > sealed_len:
            issues.append({"kind": "torn-shard-tail", "shard": w,
                           "bytes": size - sealed_len,
                           "detail": f"md.{w}.shard has "
                                     f"{size - sealed_len} bytes past its "
                                     f"sealed prefix (writer crash during "
                                     f"prepare)"})
        orphans = [s for s, _ in sealed if s not in seen]
        if orphans:
            notes.append({"kind": "orphaned-prepare", "shard": w,
                          "steps": orphans,
                          "detail": f"md.{w}.shard sealed step(s) "
                                    f"{orphans} that never committed "
                                    f"(prepare succeeded, commit did not)"})
        shards.append({"shard": w, "sealed_steps": [s for s, _ in sealed],
                       "sealed_bytes": sealed_len, "file_bytes": size})

    return {"path": str(path), "committed_steps": committed,
            "consistent_prefix_steps": [r[0] for r in records[:prefix]],
            "issues": issues, "notes": notes, "shards": shards,
            "_records": records, "_sizes": sizes, "_max_end": max_end}


def deep_scan(path, report: dict) -> list[dict]:
    """`--deep`: walk every committed chunk's JBPC block headers without
    decompressing. Validates per block: magic, codec id (incl. lossy and
    its sub-header length), known flag bits (the pre-shuffled bit), and
    the length chain tiling the chunk payload exactly; per chunk: the
    summed raw sizes must equal extent x dtype.itemsize. Ranged payload
    reads go through BpReader, so striped subfiles work unchanged."""
    import numpy as np

    from repro_torch.core import compression as C
    from repro_torch.core.bp_engine import BpReader
    issues: list[dict] = []
    known_flags = C.FLAG_PRESHUFFLED
    with BpReader(path) as reader:
        for step, _off, _ln, ok, _why, parsed in report["_records"]:
            if not ok:
                continue
            for name, var in parsed.get("vars", {}).items():
                itemsize = np.dtype(var["dtype"]).itemsize
                for ch in var["chunks"]:
                    where = (f"step {step} var {name!r} "
                             f"data.{ch['agg']}[{ch['foff']}..]")
                    try:
                        payload = reader._read_payload(
                            ch["agg"], ch["foff"], ch["nbytes"])
                        blocks = list(C.iter_block_headers(payload))
                    except C.CorruptPayloadError as e:
                        issues.append({"kind": "corrupt-chunk", "step": step,
                                       "var": name, "agg": ch["agg"],
                                       "detail": f"{where}: {e}"})
                        continue
                    bad = None
                    raw_sum = 0
                    for boff, _cid, _isz, flags, raw, _comp in blocks:
                        raw_sum += raw
                        if flags & ~known_flags:
                            bad = (f"{where}: block at {boff} carries "
                                   f"unknown flag bits 0x{flags:02x}")
                            break
                    n_el = 1
                    for s in ch["extent"]:
                        n_el *= int(s)
                    if bad is None and raw_sum != n_el * itemsize:
                        bad = (f"{where}: blocks decode to {raw_sum} bytes, "
                               f"extent {tuple(ch['extent'])} x "
                               f"{var['dtype']} needs {n_el * itemsize}")
                    if bad:
                        issues.append({"kind": "corrupt-chunk", "step": step,
                                       "var": name, "agg": ch["agg"],
                                       "detail": bad})
    return issues


def repair(path, report: dict, *, trim: bool = False) -> list[str]:
    """Truncate/reseal to the last consistent step. Returns action log."""
    path = pathlib.Path(str(path))
    actions: list[str] = []
    records = report["_records"]
    prefix = len(report["consistent_prefix_steps"])
    if prefix < len(records) \
            or any(i["kind"] == "torn-idx-tail" for i in report["issues"]):
        idx_len = prefix * IDX_SIZE
        md_len = max((off + ln for step, off, ln, ok, *_ in
                      records[:prefix]), default=0)
        os.truncate(path / "md.idx", idx_len)
        if (path / "md.0").exists():    # scan tolerates a lost md.0 too
            os.truncate(path / "md.0", md_len)
        actions.append(f"resealed md.idx/md.0 to the first {prefix} "
                       f"consistent step(s) ({idx_len}/{md_len} bytes)")
    for sh in report["shards"]:
        if sh["file_bytes"] > sh["sealed_bytes"]:
            os.truncate(path / f"md.{sh['shard']}.shard", sh["sealed_bytes"])
            actions.append(f"truncated md.{sh['shard']}.shard torn tail "
                           f"({sh['file_bytes'] - sh['sealed_bytes']} bytes)")
    if trim:
        # recompute referenced ends over the KEPT records only
        keep_end: dict[int, int] = {}
        for step, off, ln, ok, why, parsed in records[:prefix]:
            for var in parsed.get("vars", {}).values():
                for ch in var["chunks"]:
                    keep_end[ch["agg"]] = max(keep_end.get(ch["agg"], 0),
                                              ch["foff"] + ch["nbytes"])
        for agg, sz in sorted(report["_sizes"].items()):
            plain = path / f"data.{agg}"
            end = keep_end.get(agg, 0)
            if not plain.exists():
                if sz is not None and sz > end:
                    actions.append(f"skipped trim of striped data.{agg} "
                                   f"(trim supports plain subfiles only)")
                continue
            if plain.stat().st_size > end:
                os.truncate(plain, end)
                actions.append(f"trimmed data.{agg} orphan payload to "
                               f"{end} bytes")
    return actions


def _public(report: dict) -> dict:
    return {k: v for k, v in report.items() if not k.startswith("_")}


def main(argv=None) -> int:
    ap = R.make_parser(
        "jbpfsck", "O(metadata) integrity scan & repair of a JBP (BP4) "
        "series — torn steps, orphaned extents, shard damage")
    ap.add_argument("series", help="path to the <name>.bp4 directory")
    ap.add_argument("--repair", action="store_true",
                    help="truncate/reseal to the last consistent step")
    ap.add_argument("--trim", action="store_true",
                    help="with --repair: drop orphaned payload bytes from "
                         "plain subfiles")
    ap.add_argument("--deep", action="store_true",
                    help="also walk every committed chunk's JBPC block "
                         "headers (no decompression)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable report")
    args = ap.parse_args(argv)

    err = R.check_series(args.series)
    if err is not None:
        print(f"jbpfsck: {err}", file=sys.stderr)
        return R.EXIT_USAGE

    report = scan(args.series)
    repaired: list[str] = []
    if args.repair and report["issues"]:
        repaired = repair(args.series, report, trim=args.trim)
        report = scan(args.series)               # verify the repair took
    elif args.repair and args.trim:
        repaired = repair(args.series, report, trim=True)
        report = scan(args.series)
    if args.deep:
        # after any repair: deep-walk only what is (now) committed. Deep
        # findings are payload damage repair cannot fix — report only.
        report["issues"].extend(deep_scan(args.series, report))

    out = _public(report)
    out["repaired"] = repaired
    if args.as_json:
        print(json.dumps(out, indent=1))
    else:
        print(f"jbpfsck: {report['path']}")
        print(f"  committed steps: {len(report['committed_steps'])} "
              f"{report['committed_steps']}")
        for i in report["issues"]:
            print(f"  ISSUE [{i['kind']}] {i['detail']}")
        for n in report["notes"]:
            print(f"  note  [{n['kind']}] {n['detail']}")
        for a in repaired:
            print(f"  repair: {a}")
        if not report["issues"]:
            print("  clean")
    if args.io_report:
        R.io_report("jbpfsck")
    return R.EXIT_OK if not report["issues"] else R.EXIT_ISSUES


if __name__ == "__main__":
    raise SystemExit(R.run_tool(main))
