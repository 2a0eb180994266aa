"""Distributed-training pieces of the port: the sharding rules as data
(``sharding``); tensor parallelism over the model axis
(``tensor_parallel``), FSDP over the data axis (``fsdp``) and the
training step's reductions (``data_parallel``); the one seam every
collective goes through, live or counted by the dry-run
(``collectives``); the int8 gradient compression (``compression``); and
the reference's elastic policy (``elastic``, a copy)."""
