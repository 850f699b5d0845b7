"""Transform spec, operator graph and lowering, and the produce engine."""
