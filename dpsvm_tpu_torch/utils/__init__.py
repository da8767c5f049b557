"""Host utilities: native bridges and solver checkpoints."""
