"""KV block management: for now only the event consolidator."""
