"""LogisticRegression application (ref: Applications/LogisticRegression)."""

from .config import Configure  # noqa: F401
from .model import FTRLModel, LocalModel, PSModel, create_model  # noqa: F401
from .reader import (Batch, PrefetchReader, Sample, iter_samples,  # noqa: F401
                     make_batches, parse_text_line)
