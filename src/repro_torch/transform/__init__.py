"""Multilevel transforms (hb) on tensors."""
