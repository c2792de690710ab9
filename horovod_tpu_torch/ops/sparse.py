"""Sparse gradient exchange (the JAX package's ``ops/sparse.py``; the
IndexedSlices path of Horovod's ``tensorflow/__init__.py:92-108``): the
(row index, row value) pairs of every member are allgathered instead of
allreducing a dense tensor, and duplicate indices mean "sum these rows"."""

from __future__ import annotations

from horovod_tpu_torch.ops import collective_ops as C


def sparse_allreduce(indices, values, average=True, name=None,
                     process_set=C.global_process_set):
    """Every member's ``indices`` [nnz] and ``values`` [nnz, ...]
    concatenated in rank order; nnz may differ per member. With
    ``average`` the values are divided by the number of participants,
    which is the set's size: only members reach the gathers (a
    non-member's call raises ``ValueError``), so the JAX traced path's
    one-row marker count is not needed."""
    del name
    all_indices = C.allgather(indices, process_set=process_set)
    all_values = C.allgather(values, process_set=process_set)
    if average:
        all_values = all_values / process_set.size()
    return all_indices, all_values


def apply_sparse(dense, indices, values):
    """``dense`` with ``values`` added at rows ``indices``, out of place;
    duplicate indices accumulate."""
    return dense.clone().index_add_(0, indices, values.to(dense.dtype))


def sparse_allreduce_apply(dense, indices, values, average=True, name=None,
                           process_set=C.global_process_set):
    """:func:`sparse_allreduce` then :func:`apply_sparse` into ``dense``."""
    gi, gv = sparse_allreduce(indices, values, average=average, name=name,
                              process_set=process_set)
    return apply_sparse(dense, gi, gv)
