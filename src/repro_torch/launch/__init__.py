"""Entry points of the port: the preprocessing server (``serve_preprocess``)."""
