"""Perf labs of the port: measurements of one kernel or layer, run as modules."""
