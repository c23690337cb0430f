"""Multi-device layers of the port. Only the CLI flags so far
(``parallel/cli.py``); the meshes, data-parallel training and the temporal
pipeline come with ROADMAP A13."""
