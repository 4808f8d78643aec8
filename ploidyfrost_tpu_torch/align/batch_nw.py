# Host part of ploidyfrost_tpu/align/batch_nw.py (needleman_wunsch_batch).
"""Batched Needleman-Wunsch for the analysis phase.

Every first-pair DP of an analysis phase is computed in one call to the
native flag kernel (native/nw_flags.cpp), followed by the host
co-optimal traceback per pair. Without a C++ toolchain the per-pair
numpy wavefront of align/nw.py takes over (any scoring). The JAX
package's device wavefront (`nw_matrices_batched`) is not part of this
package: the native kernel always runs first there too.
"""

from __future__ import annotations


def needleman_wunsch_batch(
    pairs: list[tuple[str, str]],
    match: float = 2.0,
    dis_match: float = -1.0,
    gap: float = -3.0,
):
    """Batch counterpart of nw.needleman_wunsch: DP flag matrices in
    batch + host co-optimal traceback per pair."""
    from .nw import _nw_matrix, _traceback, nw_matrices_native

    mats = nw_matrices_native(pairs, match, dis_match, gap)
    if mats is None:
        mats = [_nw_matrix(A, B, match, dis_match, gap) for A, B in pairs]
    return [
        _traceback(U, L2, L3, A, B, match, dis_match, gap)
        for (U, L2, L3), (A, B) in zip(mats, pairs)
    ]
