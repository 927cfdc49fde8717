"""In-process actor runtime: zoo, worker, server, controller, virtual
clusters."""

from .cluster import LocalCluster  # noqa: F401
