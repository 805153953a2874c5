"""The node-sharded wave solve.

Port of ``kubernetes_tpu/parallel/``. When a wave outgrows one device,
its node axis shards over a device mesh (``mesh.Mesh``): the node planes
split into equal contiguous slices, one per shard, and the commit loop
(``sharded_scan``) runs every pod step on all shards at once, with each
node-axis reduction (the tie-break's top and count, the LeastRequested
divisor, the spread maximum, the zone sums) made across shards. Decisions
are bit-identical to the single-device solve.
"""
