"""The benchmark of the PyTorch/CUDA port (``bialign_tpu_torch``): a
harness driven by the entries of ``BENCHMARK.json`` (configurations,
traffic mixes, metric readers found by name), a plain reference of the
recurrence that decides ``correct``, and the yardstick's arithmetic.  See
``run.py``."""
