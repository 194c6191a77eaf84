"""The multi-device path: W ranks of one torch.distributed process group
prove with their sum-checks sharded (mesh.py, sumcheck_shard.py)."""
