"""The mesh backend: row shards over an ordered list of devices."""
