"""Sequence and alignment input (numpy)."""
