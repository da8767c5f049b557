"""Host utilities: native bridges, solver checkpoints and the environment
of child processes."""
