"""Core: model registry and lattice engine."""
