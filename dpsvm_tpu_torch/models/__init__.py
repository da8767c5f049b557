"""Model containers and serialization."""
