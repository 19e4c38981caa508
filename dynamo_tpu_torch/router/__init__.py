"""The worker-side half of the KV router: KV event publication."""
