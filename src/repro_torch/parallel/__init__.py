"""Splits of the serving state over the ranks of a model axis."""
