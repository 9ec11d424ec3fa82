"""The port's copies of the scheduler pieces its serving tier needs:
``shard.HashRing``, the consistent-hash ring the Router pins sessions
with."""
