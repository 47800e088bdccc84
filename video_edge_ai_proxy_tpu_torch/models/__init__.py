"""Models of the port: building blocks, YOLOv8, registry, weight carry-over."""
