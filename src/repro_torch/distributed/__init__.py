"""Distributed-training pieces of the port. One card so far: the
gradient compression (``compression``), which a single device runs as
the reference does before its all-reduce; the sharding rules as data
(``sharding``), which the dry-run records; and the reference's elastic
policy (``elastic``, a copy)."""
