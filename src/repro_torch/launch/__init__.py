"""Launchers: serving (``serve``), training on one device (``train``)."""
