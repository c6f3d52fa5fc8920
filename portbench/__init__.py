"""The benchmark of the PyTorch/H100 port (``repro_torch``): one command
runs one cell (``portbench/run.py``); see ``portbench/README.md``."""
