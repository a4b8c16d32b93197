"""Driver pipelines built on the migrate engine: the periodic N-body drift
loop (BASELINE config 4)."""
