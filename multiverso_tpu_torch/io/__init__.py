"""Stream IO and checkpointing."""

from .stream import (CheckpointError, Stream,  # noqa: F401
                     StreamFactory, TextReader, load_checkpoint,
                     read_bytes_or_none, save_checkpoint,
                     write_bytes_atomic)
