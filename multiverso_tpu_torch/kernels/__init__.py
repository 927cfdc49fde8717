"""The port's hand-written Hopper kernels, each beside its plain version.

=================  ========================  ============================
kernel             wrapper                   replaces (reference program)
=================  ========================  ============================
subsample_compact  ``subsample.py``          ``_prep`` (B4)
row_gather         ``rows.py``               ``MatrixServer._gather`` (B1)
row_scatter_add    ``rows.py``               ``DefaultRule/SGDRule.rows``
                                             via ``apply_rows`` (B2)
banded_sgns_grad   ``sgns.py``               ``_block_step_fn`` SGNS (B10)
=================  ========================  ============================

A wrapper given a CUDA tensor launches its kernel (built at first use
by ``build.py``) or raises; given a CPU tensor it runs the plain
version. Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

from typing import Dict

from .rows import row_gather, row_scatter_add
from .sgns import banded_sgns_grad
from .subsample import subsample_compact

WRAPPERS = {
    "subsample_compact": subsample_compact,
    "row_gather": row_gather,
    "row_scatter_add": row_scatter_add,
    "banded_sgns_grad": banded_sgns_grad,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
