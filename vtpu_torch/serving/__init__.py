"""Serving tier of the port: ``PagedBatcher`` over a ``BlockPool``."""
