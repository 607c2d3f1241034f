"""One module per entry point of the port that a cell drives; a cell names
its driver under ``entry``."""
