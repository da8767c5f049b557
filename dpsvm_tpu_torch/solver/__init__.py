"""Block-engine solver."""
