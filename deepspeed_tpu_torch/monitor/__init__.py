"""Serving instrumentation: the compile ledger behind ``ServeCounters.compiles``."""
