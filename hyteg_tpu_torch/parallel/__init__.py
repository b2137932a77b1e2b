"""Multi-shard execution: shard groups (comm.py) and the sharded solvers
(spmd.py)."""
