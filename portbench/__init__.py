"""The benchmark of the PyTorch/CUDA port: ``BENCHMARK.json``'s cells, run one at a
time by ``python3 -m portbench.run`` (see ``run.py``)."""
