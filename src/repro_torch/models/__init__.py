"""The LM family: layers, attention and the transformer stack."""
