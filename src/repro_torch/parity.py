"""The rule by which two rankings of the same queries agree.

Two implementations of one exact method (the reference and the port, the
card and the CPU, a kernel and the dense oracle) sum in different orders,
so their f32 scores differ in the last bits and a near-tie may swap two
labels. They agree when the scores lie within a stated tolerance and the
labels are equal wherever the reference's score gap to both neighbours in
its ranked list exceeds that tolerance.
"""

from __future__ import annotations

import numpy as np

#: Scores: the tolerance the reference's tests use across methods.
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-6


def check_ranking(s, l, s_ref, l_ref, what: str = "", *,
                  rtol: float = SCORE_RTOL, atol: float = SCORE_ATOL) -> int:
    """Raise ``AssertionError`` unless ``(s, l)`` agrees with the reference
    ``(s_ref, l_ref)`` ([n, k] scores and labels, ranked). Returns the number
    of label positions that differ, all of them within near-ties."""
    s, l, s_ref, l_ref = (np.asarray(a) for a in (s, l, s_ref, l_ref))
    if s.shape != s_ref.shape or l.shape != l_ref.shape:
        raise AssertionError(f"{what}: shapes {s.shape} vs {s_ref.shape}")
    if not (np.isfinite(s).all() and np.isfinite(s_ref).all()):
        raise AssertionError(f"{what}: non-finite scores")
    np.testing.assert_allclose(s, s_ref, rtol=rtol, atol=atol, err_msg=what)
    tol = atol + rtol * np.abs(s_ref)
    gap = np.abs(np.diff(s_ref, axis=1))
    inf = np.full((s_ref.shape[0], 1), np.inf)
    decided = (np.concatenate([inf, gap], 1) > tol) & (np.concatenate([gap, inf], 1) > tol)
    differ = l != l_ref
    if (differ & decided).any():
        raise AssertionError(f"{what}: labels differ where the score gap exceeds the tolerance")
    return int(differ.sum())
