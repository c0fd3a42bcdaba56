"""Multi-process training of the port: the process runtime, the rank grid
and its groups, and USP sequence parallelism."""
