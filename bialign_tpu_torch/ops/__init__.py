"""Device code of the port: band fills, band handle, checkpointed band,
traceback walks."""
