"""Traffic: the closed-loop generator that reads a cell's traffic
parameters, and the frozen ``percentile``."""
