"""Synthetic corpora calibrated to the paper's collections, the LM token
pipeline, the recsys batches and the graph substrate."""
