"""Synthetic corpora calibrated to the paper's collections."""
