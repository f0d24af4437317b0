"""The benchmark of the PyTorch and CUDA port (``fhe_regex_tpu_torch``):
encrypted regex matches through the port's serving daemon.  See
``README.md`` and ``run.py``."""
