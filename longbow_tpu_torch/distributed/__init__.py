"""The cluster layer. Only the consistent-hash ring is ported so far (the
client's smart routing reads it); membership, replication and the global
search wait for ROADMAP.md item 8."""
