"""Large-query heuristics over the port's exact DP (port of ``repro.heuristics``)."""
