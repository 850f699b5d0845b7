"""RM1-RM5 data configurations."""
