"""Checkers of the PyTorch port (see `checker.elle`)."""
