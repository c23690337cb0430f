"""Door-task command-line entry points."""
