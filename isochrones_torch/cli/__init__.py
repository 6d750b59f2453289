"""Command-line entry points of the port (counterpart of ``isochrones_tpu/cli``)."""
