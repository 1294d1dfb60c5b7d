"""ROC/AUC and accuracy metrics from (label, decision value) pairs.

Equivalent of stem_kernel/utils/roc.rb:3-60: the ROC curve is traced by
descending decision values over positives and negatives (ties advance both),
AUC by trapezoid integration; acc/sp/sn use a decision threshold (default 0).
"""

from __future__ import annotations

import numpy as np


def roc_curve_and_auc(labels: np.ndarray, dec: np.ndarray) -> tuple[float, np.ndarray]:
    """(AUC, curve) where curve rows are (fpr, tpr); labels >= 0 are positive."""
    labels = np.asarray(labels)
    dec = np.asarray(dec, dtype=np.float64)
    pos = np.sort(dec[labels >= 0])[::-1]
    neg = np.sort(dec[labels < 0])[::-1]
    if len(pos) == 0 or len(neg) == 0:
        return 0.0, np.array([[0.0, 0.0], [1.0, 1.0]])
    pts = [[0.0, 0.0]]
    tp = fp = i = j = 0
    while i < len(pos) and j < len(neg):
        if pos[i] > neg[j]:
            tp += 1
            i += 1
        elif pos[i] < neg[j]:
            fp += 1
            j += 1
        else:
            tp += 1
            fp += 1
            i += 1
            j += 1
        pts.append([fp / len(neg), tp / len(pos)])
    pts.append([1.0, 1.0])
    curve = np.asarray(pts)
    auc = float(np.trapezoid(curve[:, 1], curve[:, 0]))
    return auc, curve


def acc_sp_sn(labels: np.ndarray, dec: np.ndarray, th: float = 0.0) -> tuple[float, float, float]:
    """(accuracy, specificity, sensitivity) at threshold th (roc.rb:40-60)."""
    labels = np.asarray(labels)
    dec = np.asarray(dec, dtype=np.float64)
    pos = labels >= 0
    pred_pos = dec >= th
    tp = int(np.sum(pos & pred_pos))
    fn = int(np.sum(pos & ~pred_pos))
    fp = int(np.sum(~pos & pred_pos))
    tn = int(np.sum(~pos & ~pred_pos))
    acc = (tp + tn) / max(tp + tn + fp + fn, 1)
    sp = tn / max(tn + fp, 1)
    sn = tp / max(tp + fn, 1)
    return acc, sp, sn
