"""Synthetic corpora calibrated to the paper's collections, and the LM
token pipeline."""
