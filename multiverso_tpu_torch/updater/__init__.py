"""Server-side update rules applied in place to torch table storage."""

from .engine import UpdateEngine, bucket_size, pad_ids, pad_rows  # noqa: F401
from .options import AddOption, GetOption  # noqa: F401
from .rules import (AdaGradRule, DCASGDRule, DefaultRule,  # noqa: F401
                    MomentumRule, SGDRule, UpdaterRule, create_rule)
