"""Simulator scene loader and Monte-Carlo noise."""
