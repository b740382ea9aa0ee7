"""Port of ``repro/core/boundary.py``, verbatim: the search is pure Python.

Accuracy-boundary search in a monotone 2D space (paper §4.2, Fig. 8).

Accuracy is (assumed) monotone non-decreasing along both axes of a
(sampling x resolution) grid.  The *accuracy boundary* is, per row, the
poorest column whose accuracy is adequate.  A staircase walk starting at the
richest row probes O(rows + cols) cells instead of rows x cols: as the row
gets poorer, the minimal adequate column can only move richer, so the column
pointer never moves left.

Unlike the classic saddleback search for a single element, VStore must
traverse the *entire* boundary: every minimal adequate point is a candidate,
because adequacy does not imply minimal consumption cost (paper §4.2).
"""

from __future__ import annotations

from typing import Callable


def boundary_search(n_rows: int, n_cols: int,
                    adequate: Callable[[int, int], bool]
                    ) -> tuple[list[tuple[int, int]], int]:
    """Walk the accuracy boundary of a monotone grid.

    ``adequate(r, c)`` probes the cell with row ``r`` (poorest row = 0) and
    column ``c`` (poorest col = 0); both axes are monotone: if (r, c) is
    adequate then any (r', c') with r' >= r, c' >= c is adequate.

    Returns (boundary points, number of probes).  Boundary points are the
    per-row minimal adequate cells (for rows that have any adequate cell).
    """
    probes = 0
    points: list[tuple[int, int]] = []
    c = 0  # minimal adequate column so far, scanning rows richest -> poorest
    for r in range(n_rows - 1, -1, -1):
        # advance c to the minimal adequate column for this row
        found = None
        while c < n_cols:
            probes += 1
            if adequate(r, c):
                found = (r, c)
                break
            c += 1
        if found is None:
            break  # no adequate cell in this row; poorer rows can't have any
        points.append(found)
    return points, probes
