"""The serving edge: the transport-free Flight handlers (flight_handlers.py)
with their middleware, search coalescing, the ingest queue and request
security; the pyarrow Flight binding (flight_server.py) and the client
(client.py), the only modules here that need pyarrow."""
