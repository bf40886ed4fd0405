"""Filter models: feature bank, Jacobians, MSCKF update, engine."""
