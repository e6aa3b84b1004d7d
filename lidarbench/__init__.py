"""The benchmark of the PyTorch and CUDA LiDAR engine
(``lidar_processing_tpu_torch``): cells in ``BENCHMARK.json``, one run a
cell with ``python3 -m lidarbench.run``."""
