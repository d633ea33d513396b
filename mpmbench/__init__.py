"""mpmbench: the benchmark of the PyTorch and CUDA port, claymore_tpu_torch.

``run.py`` is its command; ``README.md`` says how it is laid out and how a
configuration, a cell or a metric is added.
"""
