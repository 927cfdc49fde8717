"""The port's hand-written Hopper kernels, each beside its plain version.

=================  ========================  ============================
kernel             wrapper                   replaces (reference program)
=================  ========================  ============================
subsample_compact  ``subsample.py``          ``_prep`` (B4)
row_gather         ``rows.py``               ``MatrixServer._gather`` (B1)
row_scatter_add    ``rows.py``               ``DefaultRule/SGDRule.rows``
                                             via ``apply_rows`` (B2)
row_gather_        ``rows.py``               ``MatrixServer.
bounded                                      _gather_bounded`` (B1b)
row_scatter_add_   ``rows.py``               ``UpdateEngine.
bounded                                      _bounded_rows_fn`` (B2b)
segment_merge      ``segments.py``           ``_segmented_step_fn``
                                             reassembly (B11)
segment_split      ``segments.py``           ``_segmented_ids_fn`` slices,
                                             ``_segmented_step_fn``
                                             re-slicing (B11)
banded_sgns_grad   ``sgns.py``               ``_block_step_fn`` SGNS (B10),
                                             ``_apply_step`` SGNS (B5)
banded_cbow_grad   ``cbow.py``               ``_apply_step`` CBOW (B6)
banded_hs_sg_grad  ``hs.py``                 ``_hs_sg_loss_and_grads`` (B8)
hs_cbow_grad       ``hs.py``                 ``_hs_cbow_loss_and_grads``
                                             (B8)
pair_offset_grad   ``pair.py``               ``_seq_pair_step`` (B7)
pairlist_ns_grad   ``pairlist.py``           ``_compact_loss`` NS via
                                             ``_make_step_core`` (B9)
pairlist_hs_grad   ``pairlist.py``           ``_compact_loss`` HS via
                                             ``_make_step_core`` (B9)
sparse_lr_forward  ``logreg.py``             ``make_sparse_step`` forward
                                             (B15)
sparse_lr_apply    ``logreg.py``             ``make_sparse_step`` gradient
                                             + the models' updates (B15)
dense_lr_forward   ``logreg.py``             ``make_dense_step``'s
                                             elementwise stages (B15)
key_sort           ``keysort.py``            none: K12's, K13's and K14's
                                             id sort (stable, by row, on
                                             the card)
row_rule_apply     ``rules.py``              ``Momentum/AdaGrad/DCASGDRule.
                                             rows`` via ``apply_rows`` (B12)
rows_apply_gather  ``rules.py``              ``UpdateEngine.
                                             apply_rows_gather`` (B3)
mesh_allreduce     ``mesh.py``               ``psum``/``pmean`` of
                                             ``parallel/collective.py``,
                                             ``MASGDStep``,
                                             ``_ma_group_fn`` (B16)
=================  ========================  ============================

A wrapper given a CUDA tensor launches its kernel (built at first use
by ``build.py``) or raises; given a CPU tensor it runs the plain
version. Each wrapper counts its launches in ``<wrapper>.launches``.
The word2vec step kernels (K4-K7) are span kernels: a block owns a run
of centers and writes every gradient row it owns once, then a one-warp
launch sums the blocks' loss partials in order; K5 and K7 (CBOW) take
the 2W window gradients of a span's edge from the span before
(``_launch.handoff``). The plain versions flush float32 subnormals as
the reference does (``flush.py``; the kernels through ``-ftz=true``).
"""

from __future__ import annotations

from typing import Dict

from .cbow import banded_cbow_grad
from .hs import banded_hs_sg_grad, hs_cbow_grad
from .keysort import key_sort
from .logreg import dense_lr_forward, sparse_lr_apply, sparse_lr_forward
from .mesh import mesh_allreduce
from .pair import pair_offset_grad
from .pairlist import pairlist_hs_grad, pairlist_ns_grad
from .rows import (row_gather, row_gather_bounded, row_scatter_add,
                   row_scatter_add_bounded)
from .rules import row_rule_apply, rows_apply_gather
from .segments import segment_merge, segment_split
from .sgns import banded_sgns_grad
from .subsample import subsample_compact

WRAPPERS = {
    "subsample_compact": subsample_compact,
    "row_gather": row_gather,
    "row_scatter_add": row_scatter_add,
    "banded_sgns_grad": banded_sgns_grad,
    "banded_cbow_grad": banded_cbow_grad,
    "banded_hs_sg_grad": banded_hs_sg_grad,
    "hs_cbow_grad": hs_cbow_grad,
    "pair_offset_grad": pair_offset_grad,
    "pairlist_ns_grad": pairlist_ns_grad,
    "pairlist_hs_grad": pairlist_hs_grad,
    "sparse_lr_forward": sparse_lr_forward,
    "sparse_lr_apply": sparse_lr_apply,
    "dense_lr_forward": dense_lr_forward,
    "key_sort": key_sort,
    "row_rule_apply": row_rule_apply,
    "rows_apply_gather": rows_apply_gather,
    "row_gather_bounded": row_gather_bounded,
    "row_scatter_add_bounded": row_scatter_add_bounded,
    "segment_merge": segment_merge,
    "segment_split": segment_split,
    "mesh_allreduce": mesh_allreduce,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
