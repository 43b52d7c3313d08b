"""Roofline terms of the dry run's cells."""
