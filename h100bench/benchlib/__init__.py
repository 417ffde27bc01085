"""The benchmark's own library: inputs, chunking, the window, the trace."""
