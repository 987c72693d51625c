"""Models of the port: the two-tower retriever of hybrid retrieval."""
