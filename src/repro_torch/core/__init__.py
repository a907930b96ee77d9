"""Fault-model core: hashing, voltage -> rate model, fault maps, placement
and the arena injection engine."""
