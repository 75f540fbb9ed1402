"""Synthetic datasets for quality and smoke runs."""
