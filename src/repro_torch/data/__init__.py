"""Columnar data, synthetic RM sources, the partitioned store and synthetic
token streams."""
