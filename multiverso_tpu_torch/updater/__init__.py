"""Server-side update rules applied in place to torch table storage."""

from .engine import UpdateEngine, bucket_size, pad_ids, pad_rows  # noqa: F401
from .options import AddOption, GetOption  # noqa: F401
from .rules import DefaultRule, SGDRule, UpdaterRule, create_rule  # noqa: F401
