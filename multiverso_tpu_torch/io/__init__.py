"""Stream IO: local files behind the reference's stream factory."""

from .stream import Stream, StreamFactory, TextReader  # noqa: F401
