"""Synthetic certificate builders for tests and the card smoke run."""
