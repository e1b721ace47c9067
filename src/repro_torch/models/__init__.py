"""The LM family (layers, attention, the transformer stack) and the recsys
family (embeddings, recurrent cells, DIEN)."""
