"""Ingest of the port: the video-source types and the synthetic pattern
source the replay plane regenerates frames from."""
