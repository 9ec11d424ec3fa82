"""The port's copy of the shared region the node monitor reads."""
