"""Reporting: waterfall tables, CSV and Wilson intervals."""
