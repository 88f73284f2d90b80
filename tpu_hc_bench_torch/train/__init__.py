"""The training lane of the port: the step and the benchmark driver."""
