"""Models of the port: the recsys family (DLRM, SASRec, DIN and the
two-tower retriever of hybrid retrieval) and the transformer LM family."""
