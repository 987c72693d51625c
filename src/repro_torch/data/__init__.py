"""Synthetic corpora calibrated to the paper's collections, the LM token
pipeline and the recsys batches."""
