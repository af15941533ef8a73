"""Modality pipelines: byte payloads -> Records via device kernels."""
