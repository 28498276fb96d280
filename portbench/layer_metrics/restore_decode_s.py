"""The host codec's seconds decoding the restore's payloads (the inflate
and byte-unshuffle of each chunk): the program's `DECOMPRESS_TIME`
counter over the restore (`restore["decode_time"]`). Summed over reading
threads, so a parallel decode leaves it unmoved and a decode moved to the
device lowers it."""
UNIT = "s"
LAYER = "restore"
MOVES = "restore_s"


def read(run: dict):
    return (run.get("restore") or {}).get("decode_time")
