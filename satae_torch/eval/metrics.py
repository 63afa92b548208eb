"""Evaluation metrics: the port's numpy copy of satae/eval/metrics.py.

The confusion matrix, per-class precision / recall / F1 with sklearn's
0-for-0/0 convention, and the text of sklearn's
``classification_report(digits=4)``, the reference notebook's final
evaluation. The report text is character for character satae's.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def confusion_matrix(y_true, y_pred, num_classes: int) -> np.ndarray:
    """(num_classes, num_classes) int64 matrix; rows = true, cols =
    predicted. Labels outside [0, num_classes) count nowhere, as in satae's
    one-hot product."""
    classes = np.arange(num_classes)
    onehot_true = np.asarray(y_true)[:, None] == classes[None, :]
    onehot_pred = np.asarray(y_pred)[:, None] == classes[None, :]
    return onehot_true.astype(np.int64).T @ onehot_pred.astype(np.int64)


def per_class_metrics(cm: np.ndarray) -> Dict[str, np.ndarray]:
    """precision/recall/f1/support per class + accuracy, macro and weighted
    averages, with sklearn's 0-for-0/0 convention."""
    cm = np.asarray(cm, np.float64)
    tp = np.diag(cm)
    support = cm.sum(axis=1)
    pred_n = cm.sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(pred_n > 0, tp / pred_n, 0.0)
        recall = np.where(support > 0, tp / support, 0.0)
        denom = precision + recall
        f1 = np.where(denom > 0, 2 * precision * recall / denom, 0.0)
    total = support.sum()
    weights = support / total if total else support
    return {
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "support": support.astype(np.int64),
        "accuracy": tp.sum() / total if total else 0.0,
        "macro_precision": precision.mean(),
        "macro_recall": recall.mean(),
        "macro_f1": f1.mean(),
        "weighted_precision": float((precision * weights).sum()),
        "weighted_recall": float((recall * weights).sum()),
        "weighted_f1": float((f1 * weights).sum()),
    }


def classification_report(y_true, y_pred, num_classes: int,
                          target_names: Optional[Sequence[str]] = None,
                          digits: int = 4,
                          cm: Optional[np.ndarray] = None) -> str:
    """sklearn-compatible text report (digits=4 as in the reference). Pass
    ``cm`` when the caller already built the confusion matrix from the same
    labels and predictions."""
    if cm is None:
        cm = confusion_matrix(y_true, y_pred, num_classes)
    m = per_class_metrics(cm)
    names = list(target_names) if target_names else [
        str(i) for i in range(num_classes)]
    width = max(len(n) for n in names + ["weighted avg"])
    head_fmt = "{:>{width}} " + " {:>9}" * 4
    row_fmt = "{:>{width}} " + " {:>9.{digits}f}" * 3 + " {:>9}"
    lines = [head_fmt.format("", "precision", "recall", "f1-score", "support",
                             width=width), ""]
    for i, name in enumerate(names):
        lines.append(row_fmt.format(name, m["precision"][i], m["recall"][i],
                                    m["f1"][i], int(m["support"][i]),
                                    width=width, digits=digits))
    lines.append("")
    total = int(m["support"].sum())
    lines.append(("{:>{width}} " + " {:>9}" * 2 + " {:>9.{digits}f} {:>9}")
                 .format("accuracy", "", "", m["accuracy"], total,
                         width=width, digits=digits))
    for avg in ("macro", "weighted"):
        lines.append(row_fmt.format(
            f"{avg} avg", m[f"{avg}_precision"], m[f"{avg}_recall"],
            m[f"{avg}_f1"], total, width=width, digits=digits))
    return "\n".join(lines)
