"""The harness's shared pieces: cell lookup, counts and peaks, the
reduction of a profiler slice, the run's seeds."""
