"""Models of the port: the recsys family (DLRM, SASRec, DIN and the
two-tower retriever of hybrid retrieval), the transformer LM family and
SchNet, the GNN."""
