"""Host utilities: the flag/config surface."""
