"""Device-mesh sharding: rendering and training over several devices or
processes (parallel/sharded.py)."""
