"""The benchmark's yardstick: seeds, tracing, checking, the roofline and the diagnostics."""
