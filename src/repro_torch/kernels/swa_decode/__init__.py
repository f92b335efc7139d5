"""swa_decode: one-token attention over a ring-buffer KV cache."""
