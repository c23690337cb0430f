"""Multi-device layers of the port (port of ``multimodalfilter_tpu/parallel``):
one process per device, ``torch.distributed`` meshes with named axes
(``mesh.py``), explicit collectives (``collectives.py``), data-parallel
training and eval and the routing of a loop over a grid
(``data_parallel.py``), particle sharding (``particle_sharding.py``), the
temporal pipeline (``temporal_pipeline.py``), the CLI flags (``cli.py``),
a launcher for tests and smoke runs (``launch.py``) and a dry run
(``dryrun.py``)."""
