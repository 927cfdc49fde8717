"""Applications on the port's parameter server."""
