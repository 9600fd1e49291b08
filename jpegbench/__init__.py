"""The benchmark of the PyTorch and CUDA port (``jpeg_gpu_tpu_torch``): cells
named in ``BENCHMARK.json``, one run of one cell by ``python -m
jpegbench.run``.  See ``run.py``."""
