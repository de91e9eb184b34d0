"""The serving core: search coalescing, the ingest queue and request
security. The Arrow Flight edge (longbow_tpu/serving/flight_server.py,
middleware.py, client.py) is not ported yet."""
