"""Query workloads (port of ``repro.workloads``)."""
