"""Models of the port: the two-tower retriever of hybrid retrieval and
the transformer LM family (serving half)."""
