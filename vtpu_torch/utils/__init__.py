"""Host-side helpers of the port: env parsing, a true completion
barrier and the pinned host tier."""
