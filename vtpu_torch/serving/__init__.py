"""Serving tier of the port: ``ContinuousBatcher`` over the dense KV
cache, ``PagedBatcher`` over a ``BlockPool``, and
the disaggregated ``PrefillEngine``/``DecodeEngine`` with the K/V wire
transport and its codecs, the prefix registry and host spill tier with
its journal (``kvpersist``), and live session moves (``migrate``)."""
