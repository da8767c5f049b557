"""The plain reference: torch in float64, written from the C-SVC dual and
the RBF kernel, importing nothing of the measured program."""
