"""Replica ensembles and training sharded over ranks (port of
upside_md_tpu/parallel/): `mesh.py` and the multi-rank dry run,
`dryrun.py`."""
