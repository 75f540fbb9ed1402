"""Trained model classes."""
