"""Serving instrumentation: the compile ledger behind ``ServeCounters.compiles``
and request tracing (span chains, SLO histograms, the flight recorder)."""
