"""Mesh collectives and model-average training (port of
``multiverso_tpu/parallel``)."""

from .collective import (allreduce_mesh, pmean_mesh, psum_scalar)  # noqa: F401
from .ma import (MAAverager, MAFuture, MASGDStep,  # noqa: F401
                 MAShardedAverager, model_average, model_average_async,
                 sharded_model_average, sharded_model_average_async)
