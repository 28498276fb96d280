"""Command-line maintenance tools for JBP/openPMD series
(`python -m repro_torch.tools.<x>`):

    jbpls      bpls-style metadata listing (O(metadata), zero data.* reads)
    jbprepack  rewrite a series at a new aggregator count / codec /
               striping — byte-equivalent under the reader
    jbpfsck    O(metadata) integrity scan; --repair truncates/reseals to
               the last consistent step
    jbpd       long-lived series data service: metadata queries + box
               reads over a socket for many concurrent clients, with an
               LRU decompressed-chunk cache, request coalescing and
               zero-copy shm responses (--stats/--shutdown administer a
               running daemon)

All four share the `repro_torch.tools._runner` conventions: exit codes
(0 clean, 1 issues, 2 not-a-series), `--io-report` (the tool's own merged
Darshan counters), and `--parallel N` (ReaderPool fan-out) where payload
reads happen.
"""
