"""Device code of the port: band fills, band handle, traceback walks."""
