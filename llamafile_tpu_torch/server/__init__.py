"""HTTP serving of the port: continuous batcher and OpenAI-style server."""
