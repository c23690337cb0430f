"""The benchmark of the PyTorch and CUDA port (``multimodalfilter_tpu_torch``):
one command runs one cell (a configuration under a traffic mix) once, on
one H100. See ``README.md`` and ``BENCHMARK.json`` at the repository root."""
