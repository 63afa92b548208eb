"""Evaluation: confusion matrix, per-class metrics and the report text."""
