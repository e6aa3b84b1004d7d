"""Tool entry points: the port's counterparts of the repo's tools/.

``golden_run`` is the golden parity run (also ``python -m
lidar_processing_tpu_torch golden``). Each probe module (``probe_*``) has
``make_inputs`` (the JAX probe's seeded numpy draws) and
``main(device=None, ...)``, runnable as
``python -m lidar_processing_tpu_torch.tools.<probe>``. They run on the
card unless the caller names another device (the plain twins then run).
``bench_batch`` is root tools/bench_batch.py's counterpart (ms/frame of
the batched step at several B); ``step_bench`` compares trees' steps;
``scaling_bench`` is root tools/scaling_bench.py's (frames/s against the
shards of a mesh, on one rank, spawned ranks or torchrun).
``measure_caps`` (cap occupancies), ``tier_hist`` (ambiguous-pair size
histograms) and ``profile_stages`` (per-stage times) are the root tools'
counterparts over a frame directory (``--data-dir``), each a ``main(argv)``
returning what it prints.
"""
