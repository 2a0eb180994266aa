"""Distributed-training pieces of the port. One card so far: only the
gradient compression (``compression``), which a single device runs as
the reference does before its all-reduce."""
