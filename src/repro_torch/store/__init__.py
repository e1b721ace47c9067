"""The tiered quantized vector store and its two-stage rerank."""
