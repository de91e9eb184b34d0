"""The cluster layer: membership, replication, anti-entropy, partitioned
placement and the global search (counterpart of longbow_tpu/distributed/).

Everything here runs on the host; it talks to peers through
serving/client.py, so cluster.py and replicator.py need pyarrow.flight.
The package's __init__ imports only the pure modules, so that a single
node never loads pyarrow.
"""
from longbow_tpu_torch.distributed.merkle import MerkleTree  # noqa: F401,E402
from longbow_tpu_torch.distributed.vector_clock import VectorClock  # noqa: F401,E402
