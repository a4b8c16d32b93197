"""Timing helpers and stats summaries."""
