"""The harness: spec loading, the run, the trace reduction, and the
benchmark's own inputs and weights."""
