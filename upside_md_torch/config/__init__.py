"""System inputs for the port: numpy-only spec bundles."""
