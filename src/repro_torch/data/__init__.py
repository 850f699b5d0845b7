"""Columnar data, synthetic RM sources and the partitioned store."""
