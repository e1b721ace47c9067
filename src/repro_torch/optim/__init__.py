"""Optimizers of the fit (AdamW and global-norm clipping)."""
