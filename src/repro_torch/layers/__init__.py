"""Layers of the decoder-only LM on plain parameter dicts of tensors."""
