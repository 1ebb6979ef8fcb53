"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one
command, ``python3 bench/run.py``, runs one cell of ``BENCHMARK.json``
once on the card.  See ``bench/run.py``."""
