"""Trajectory I/O: the numpy-only HDF5 writer and reader, the logger, the
per-node log streams and the trajectory and PDB tools."""
