"""The harness's general parts: the specification it is driven by, the
closed serving loop, the trace reduction, the peaks table and the
arithmetic of the kernels' bounds."""
