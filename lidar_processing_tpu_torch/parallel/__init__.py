"""Multi-rank execution on ``torch.distributed``: the port of the JAX
package's ``parallel/``.

``mesh`` (shards over ranks, the collectives), ``sharded`` (frame
sharding, the 2-D data x space pipeline), ``spatial`` (exact x-band
clustering with halo exchange and label merge), ``frame_spatial`` (GPF and
clustering on x-bands) and ``launch`` (ranks spawned as processes, for
the tests and the scaling bench).
"""
