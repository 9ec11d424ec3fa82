"""Host-side helpers of the port: env parsing, a true completion
barrier, the pinned host tier and the trace spans (``trace``)."""
