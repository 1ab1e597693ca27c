"""Utilities: interop with the reference package's NamedTuples, stable top-k."""
