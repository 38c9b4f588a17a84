"""Train runs, model blobs, engine loading and the query server."""
