"""Data pipeline of the port: the synthetic token stream and a prefetcher
that copies batches to the device."""
