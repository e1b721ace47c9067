"""Step builders: the functions a server or trainer calls per batch."""
