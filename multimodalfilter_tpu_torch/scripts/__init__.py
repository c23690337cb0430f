"""Command-line entry points of the port (counterpart of the repo's ``scripts/``)."""
