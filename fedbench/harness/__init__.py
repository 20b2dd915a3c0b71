"""The harness: inputs from the seed, the timed window over the program,
the reading of traces and the check against the reference."""
