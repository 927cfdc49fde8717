"""In-process actor runtime: zoo, worker, server, controller."""
