"""Models of the port: ``TransformerLM`` (paged decode path)."""
