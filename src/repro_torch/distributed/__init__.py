"""The lattice's lane partitioner and its level-commit collective."""
