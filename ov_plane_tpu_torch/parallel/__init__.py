"""Information-form measurement compression."""
