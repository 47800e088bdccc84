"""Frame bus of the port: interface and the in-process backend."""
