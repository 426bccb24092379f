"""Fleet layer: so far only the engine cache keys of CPU workloads."""
