"""Serving tier of the port: ``ContinuousBatcher`` over the dense KV
cache, ``PagedBatcher`` over a ``BlockPool``, and
the disaggregated ``PrefillEngine``/``DecodeEngine`` with the K/V wire
transport and its codecs, the prefix registry and host spill tier with
its journal (``kvpersist``), live session moves (``migrate``), the
front door over them (``router.Router``) and the per-request latency
ledger the engines mark (``reqtrace.LEDGER``)."""
