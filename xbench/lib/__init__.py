"""The benchmark's own yardstick: traffic generation, peaks and bounds,
the reading of traces and spans.  Nothing here imports the program."""
