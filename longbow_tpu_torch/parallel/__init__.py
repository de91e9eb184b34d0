"""Shard-parallel search over a mesh of devices.

Counterpart of longbow_tpu/parallel/ (reference: SWIM gossip, the
consistent-hash ring, gRPC scatter-gather and the StreamAggregator
top-k merge, mesh/gossip.go, sharding/ring.go:15, scatter_gather.go:12,
stream_aggregator.go:17). As in longbow_tpu, one process drives every
shard (single-controller): the corpus is row-sharded over the mesh's
devices, each shard runs its local search on its own device, and the
per-shard top-k are gathered to the first device and merged.
"""
from longbow_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
from longbow_tpu_torch.parallel.sharded import ShardedFlatIndex  # noqa: F401
