"""Transformer building blocks of the port."""
