"""Head-churn signal of the adaptive transition schedule; the rest of
the trigger (``ClusterTrigger``) is ported with the streaming slice."""
from __future__ import annotations

import numpy as np


def head_churn(prev_ids, ids) -> float:
    """Jaccard distance between two head id SETS (order/count agnostic,
    negatives = empty slots ignored).  0.0 = identical membership,
    1.0 = disjoint.  The serve cache refresh policy compares its cached
    head against a fresh tracker export with this."""
    prev_ids = np.unique(np.asarray(prev_ids)[np.asarray(prev_ids) >= 0])
    ids = np.unique(np.asarray(ids)[np.asarray(ids) >= 0])
    union = np.union1d(prev_ids, ids)
    if union.size == 0:
        return 0.0
    inter = np.intersect1d(prev_ids, ids)
    return 1.0 - inter.size / union.size
