"""Configuration and numeric tables of the port."""
