"""Serving launchers."""
