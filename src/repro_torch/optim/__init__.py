"""Optimizers (functional ``init/update`` pairs over parameter dicts)."""
