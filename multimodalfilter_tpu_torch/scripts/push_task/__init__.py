"""Push-task command-line entry points."""
