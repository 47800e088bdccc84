"""Tensor ops of the port: boxes, preprocessing, NMS."""
