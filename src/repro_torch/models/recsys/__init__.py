"""RecSys: MIND multi-interest retrieval and the EmbeddingBag substrate."""
