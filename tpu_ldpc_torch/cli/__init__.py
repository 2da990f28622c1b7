"""Command-line entry points and the config system (L5)."""
