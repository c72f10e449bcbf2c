"""Evaluation data."""
