"""The lattice's lane partitioner and its level-commit collective, the
LLM sharding rules and the compressed gradient all-reduce."""
