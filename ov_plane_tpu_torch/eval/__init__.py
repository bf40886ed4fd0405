"""Accuracy and consistency metrics."""
